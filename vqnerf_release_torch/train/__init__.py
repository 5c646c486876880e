"""Training: the stage-2 train steps and the epoch loops."""
