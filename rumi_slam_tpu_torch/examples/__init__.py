"""Command-line drivers of the port (``python -m rumi_slam_tpu_torch.examples.<name>``),
the counterparts of the repository's ``examples/`` scripts."""
