"""Data layer: image IO without OpenCV and the stage-2 view dataset."""
