def build_model(cfg, *, device=None, **kw):
    """Factory: config -> model instance (``repro.models.build_model``):
    an ``audio`` arch builds the encoder-decoder ``EncDecLM``, every other
    (``decoder``, ``vlm``) a ``DecoderLM``.  Builds on ``cuda`` unless
    ``device`` names another device, and raises when CUDA is missing and
    no device was given (``common.resolve_device``).  ``remat`` (see
    ``models.transformer``) is dropped for an ``audio`` arch, as in the
    reference."""
    from repro_torch.common import resolve_device
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.models.whisper import EncDecLM

    device = resolve_device(device)
    if cfg.arch_type == "audio":
        kw.pop("remat", None)
        return EncDecLM(cfg, device=device, **kw)
    return DecoderLM(cfg, device=device, **kw)
