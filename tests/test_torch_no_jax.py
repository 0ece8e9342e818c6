"""The port imports neither JAX nor the JAX package: every module of
repro_torch is imported in a fresh interpreter and sys.modules checked."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), "modules;", "leaked:", bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout


_WHISPER_PROBE = """
import sys
import torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.whisper import EncDecLM
m = build_model(get_config("whisper-small-smoke"), device="cpu")
with torch.no_grad():
    frames = torch.zeros(1, m.cfg.frontend_seq, m.cfg.d_model)
    cache = m.init_cache(1, 4, frame_embeds=frames)
    m.decode_step(torch.zeros(1, 1, dtype=torch.long), cache, 0)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(type(m).__name__, "leaked:", bad)
sys.exit(1 if bad or not isinstance(m, EncDecLM) else 0)
"""


def test_whisper_builds_encodes_and_decodes_without_jax():
    """models/whisper.py, reached through build_model: building, encoding
    into the cross K/V cache and one decode step import no JAX."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _WHISPER_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "EncDecLM leaked: []" in proc.stdout
