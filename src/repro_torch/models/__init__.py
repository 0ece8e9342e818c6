def build_model(cfg, *, device=None, **kw):
    """Factory: config -> model instance (``repro.models.build_model``;
    decoder LMs only in this port).  Builds on ``cuda`` unless ``device``
    names another device, and raises when CUDA is missing and no device
    was given (``common.resolve_device``)."""
    from repro_torch.common import resolve_device
    from repro_torch.models.transformer import DecoderLM

    if cfg.arch_type != "decoder":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet")
    return DecoderLM(cfg, device=resolve_device(device), **kw)
