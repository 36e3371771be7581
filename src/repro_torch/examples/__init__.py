"""The paper layer's walkthroughs (run with ``python -m repro_torch.examples.<name>``)."""
