"""Stage-2 decomposition models as torch.nn.Modules."""
