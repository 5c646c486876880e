"""The benchmark of vqnerf_release_torch on the H100 (see README.md)."""
