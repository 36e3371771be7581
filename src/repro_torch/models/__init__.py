"""Dense transformer layers and parameter init (PyTorch)."""
