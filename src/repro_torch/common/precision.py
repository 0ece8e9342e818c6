"""Mixed-precision policy (port of ``repro.common.precision``).

Parameters are kept in ``param_dtype`` (fp32), compute runs in
``compute_dtype`` (bf16 for the LM configs, fp32 for the paper-scale
networks where analog fidelity matters), and reductions and scan carries
accumulate in ``accum_dtype``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, tree):
        """Cast every floating tensor of a (nested dict/list) tree."""
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        if torch.is_tensor(tree) and tree.is_floating_point():
            return tree.to(self.compute_dtype)
        return tree


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)
