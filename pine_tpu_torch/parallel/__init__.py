"""Counterpart of pine_tpu/parallel/: renders over several processes, one
per card, through torch.distributed."""
