"""The reference's five examples on the port, each a thin driver over the
port's entry points (``python -m repro_torch.examples.<name>``, on
``cuda`` unless given ``--device cpu``): ``quickstart``,
``train_smnist``, ``train_lm``, ``serve_batch``, ``mixed_signal_demo``."""
