"""Data preprocessing: ArUco camera conversion, COLMAP model reading and
pose conversion, real-capture dataset assembly, MERL conversion."""
