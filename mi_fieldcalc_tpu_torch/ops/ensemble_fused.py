"""The ensemble reductions of one member-stacked field in one CUDA kernel,
with its plain version.

``csrc/ensemble_stats.cu`` replaces no TPU kernel: the JAX package leaves
``mean_value``, ``stddev_value`` and ``probability``
(:mod:`mi_fieldcalc_tpu.ops.ensemble`) to XLA.  The port's plain versions
(:mod:`.ensemble`) read a ``[nmem, ...]`` stack several times and write
whole-stack temporaries; the kernel reads each value and mask byte once
and writes only the outputs, which is what bounds it (bytes).  Its plain
version is :func:`ensemble_stats_plain`, the composition of those three.

Tensors on the CPU take the plain version.  CUDA tensors take the kernel,
or the wrapper raises: it never falls back.  On a shard
(``ops.stencil.ShardCtx`` with a group) the kernel's whole-field member
flags are the maximum over the shards before the probability divides by
their count, as :func:`.ensemble.probability` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _build
from ..field import Field, f32
from ..utils.profiling import span
from ._harness import check_tensor, out_field
from .ensemble import mean_value, probability, shard_member_flags, \
    stddev_value

__all__ = ["EnsembleStats", "ensemble_stats_fused", "ensemble_stats_plain"]


class EnsembleStats(NamedTuple):
    """One member-stacked field's statistics (Fields of the member shape)."""
    mean: Field
    spread: Field
    prob: Optional[Field]     # None unless a limit was given


def _check_mode(limit, compute) -> None:
    if compute not in (None, 1, 2) or (limit is None) != (compute is None):
        raise ValueError("ensemble_stats_fused: give both limit and compute "
                         "(1 above, 2 below) or neither")


def ensemble_stats_plain(field: Field, limit=None,
                         compute=None) -> EnsembleStats:
    """The kernel's plain version: :func:`.ensemble.mean_value`,
    :func:`.ensemble.stddev_value` and, with a limit,
    :func:`.ensemble.probability` ``(compute, field, (limit,))``."""
    _check_mode(limit, compute)
    prob = (None if compute is None
            else probability(compute, field, (float(limit),)))
    return EnsembleStats(mean_value(field), stddev_value(field), prob)


def ensemble_stats_fused(field: Field, limit=None,
                         compute=None) -> EnsembleStats:
    """The mean, the population spread and, with ``limit`` and ``compute``
    (1: above, 2: below), the probability (%) of a ``[nmem, ...]`` member
    stack, as :func:`ensemble_stats_plain` gives them.

    On CUDA tensors this is one launch of the kernel (counted in
    ``ensemble_stats_fused.launches``), and with a limit a short epilogue
    over the output plane (counted in ``ensemble_stats_fused.prob_launches``);
    on CPU tensors it runs :func:`ensemble_stats_plain`."""
    dev = field.values.device
    if dev.type == "cpu":
        with span("ensemble.stats", dev):
            return ensemble_stats_plain(field, limit, compute)
    if dev.type != "cuda":
        raise ValueError(f"ensemble_stats_fused: no kernel for {dev}")
    _check_mode(limit, compute)
    return _launch(field, limit, compute)


ensemble_stats_fused.launches = 0
ensemble_stats_fused.prob_launches = 0


def _launch_args(field: Field, limit, compute) -> tuple:
    """The launches' checks, outputs and arguments, on any device:
    ``(outputs, stats args, prob args)``, the arguments those of
    ``mf_ensemble_stats`` and, with a limit, ``mf_ensemble_prob`` (else
    None) but the stream, tensors for pointers; the two share the member
    flags ``seen``."""
    name = "ensemble_stats_fused"
    values, mask = field.values, field.mask
    dev = values.device
    if values.dim() < 1 or values.shape[0] < 1:
        raise ValueError(f"{name}: need a [nmem, ...] stack of at least one "
                         f"member, got shape {tuple(values.shape)}")
    shape = tuple(values.shape)
    check_tensor(name, values, "values", shape, torch.float32, dev)
    check_tensor(name, mask, "mask", shape, torch.bool, dev)
    nmem, out_shape = shape[0], shape[1:]
    npts = values.numel() // nmem
    mean = torch.empty(out_shape, dtype=torch.float32, device=dev)
    spread = torch.empty(out_shape, dtype=torch.float32, device=dev)
    some = torch.empty(out_shape, dtype=torch.bool, device=dev)
    prob = seen = prob_some = None
    if compute is not None:
        prob = torch.empty(out_shape, dtype=torch.float32, device=dev)
        seen = torch.empty(nmem, dtype=torch.int32, device=dev)
        prob_some = torch.empty((), dtype=torch.bool, device=dev)
    out = EnsembleStats(out_field(mean, some), out_field(spread, some),
                        None if prob is None else out_field(prob, prob_some))
    stats = (values, mask, mean, spread, some, prob, seen, nmem, npts,
             compute or 0, 0.0 if compute is None else f32(limit))
    return out, stats, (None if prob is None
                        else (prob, prob_some, seen, nmem, npts))


def _launch(field: Field, limit, compute) -> EnsembleStats:
    name = "ensemble_stats_fused"
    dev = field.values.device
    out, stats, prob = _launch_args(field, limit, compute)
    ensemble_stats_fused.launches += 1
    with span("ensemble.stats", dev):
        _build.call(name, "mf_ensemble_stats", dev, *stats)
        if prob is not None:
            # the member flags ``seen``; a no-op off a shard
            shard_member_flags(prob[2])
            ensemble_stats_fused.prob_launches += 1
            _build.call(name, "mf_ensemble_prob", dev, *prob)
    return out
