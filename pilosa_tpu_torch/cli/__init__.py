"""``python -m pilosa_tpu_torch.cli``: the port's command line."""
