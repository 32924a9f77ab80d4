"""The port's serving entry, ``staging.run_derived_fields_np``, against the
JAX package's, sentinel numpy in and out, on the CPU.

The JAX entry off the TPU runs ``jax.jit(derived_fields)``, whose XLA:CPU
compile contracts multiply-adds into FMAs.  So the 7 elementwise outputs
agree within rtol 2e-5 and the 5 stencil outputs within
``2e-5*|ref| + 2e-6*max|ref|`` (see test_torch_fused.py); undefined
points (the sentinel) must be identical.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mi_fieldcalc_tpu.field import UNDEF
from mi_fieldcalc_tpu.staging import run_derived_fields_np as j_run
from mi_fieldcalc_tpu_torch import _build, native, staging

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STENCIL = ("vort", "div", "tadv", "gradt", "tfp")


def _inputs(nlev=3, ny=24, nx=40, seed=0, undefs=True):
    """The JAX package's staging test inputs (test_staging.py)."""
    rng = np.random.default_rng(seed)
    tk = rng.normal(275.0, 15.0, (nlev, ny, nx)).astype(np.float32)
    q = rng.uniform(1e-4, 1e-2, (nlev, ny, nx)).astype(np.float32)
    u = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    v = rng.normal(0.0, 12.0, (nlev, ny, nx)).astype(np.float32)
    ps = rng.normal(1000.0, 15.0, (ny, nx)).astype(np.float32)
    if undefs:
        tk[:, ny // 3, nx // 3] = UNDEF
        q[1, 2, 3] = np.nan
    alevel = np.linspace(0.0, 50.0, nlev).astype(np.float32)
    blevel = np.linspace(1.0, 0.5, nlev).astype(np.float32)
    xmapr = np.full((ny, nx), 4.0e-7, np.float32)
    ymapr = np.full((ny, nx), 3.6e-7, np.float32)
    fcor = np.full((ny, nx), 1.2e-4, np.float32)
    return tk, q, u, v, ps, alevel, blevel, xmapr, ymapr, fcor


def presampled(a, shape_to) -> np.ndarray:
    """``a`` re-gridded onto ``shape_to`` by the port's resampling decode
    and encoded back to sentinels: what an aligned request's stack is
    after its decode."""
    v, m, _ = native.decode_resample_batch([a], *shape_to)
    return np.where(m[0], v[0], np.float32(UNDEF))


def presampled_args(args, shape_to) -> tuple:
    """The pipeline's 10 sentinel arguments re-gridded as ``align=True``
    re-grids them (``_stage_step`` of the JAX package): the stacks and ps
    by the resampling decode, the map ratios rescaled, fcoriolis by plain
    bilinear, the coefficients as they are."""
    from mi_fieldcalc_tpu_torch.ingest import resample_align, resample_maps
    tk, q, u, v, ps, al, bl, xm, ym, fc = args
    xm_t, ym_t = resample_maps(xm, ym, *tk.shape[-2:], shape_to)
    return (*(presampled(a, shape_to) for a in (tk, q, u, v, ps)), al, bl,
            xm_t, ym_t, resample_align(fc, shape_to=shape_to,
                                       mask_aware=False))


@pytest.mark.parametrize("undefs", [True, False])
def test_run_derived_fields_np_matches_jax(undefs):
    args = _inputs(seed=3, undefs=undefs)
    _, all_defined = staging._decode_step(
        args, staging.HostStager(4), UNDEF)
    assert all_defined == (not undefs)          # the auto-route
    got = staging.run_derived_fields_np(*args, device="cpu")
    ref = j_run(*args)
    assert list(got) == list(ref)
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape and g.dtype == np.float32, name
        undef = r == np.float32(UNDEF)
        np.testing.assert_array_equal(g == np.float32(UNDEF), undef,
                                      err_msg=name)
        d = ~undef
        atol = 2e-6 * float(np.abs(r[d]).max()) if name in STENCIL else 0.0
        np.testing.assert_allclose(g[d], r[d], rtol=2e-5, atol=atol,
                                   err_msg=name)


def test_stager_is_reused_and_counts():
    args = _inputs(seed=5)
    stager = staging._stager_cache(4, UNDEF)
    staging.run_derived_fields_np(*args, device="cpu")
    buf = stager.values
    staging.run_derived_fields_np(*_inputs(seed=6), device="cpu")
    assert stager.values is buf                 # same shape: same block
    nlev, ny, nx = args[0].shape
    assert stager.counts[0] == nlev * ny * nx - nlev   # one undef column
    host, _ = staging._decode_step(args, stager, UNDEF)
    staged = staging._upload_step(host, torch.device("cpu"))
    # the device tensors are copies, never views of the reused buffer
    assert staged[0].values.data_ptr() != stager.values.ctypes.data
    assert staged[0].mask.dtype == torch.bool


def test_port_runs_without_jax():
    """The port imports and serves with jax unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['mi_fieldcalc_tpu'] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from mi_fieldcalc_tpu_torch.staging import run_derived_fields_np\n"
        "rng = np.random.default_rng(0)\n"
        "s = (2, 6, 7)\n"
        "tk = rng.normal(275, 15, s).astype(np.float32); tk[0, 2, 2] = 1e35\n"
        "q = rng.uniform(1e-4, 1e-2, s).astype(np.float32)\n"
        "u = rng.normal(0, 12, s).astype(np.float32)\n"
        "v = rng.normal(0, 12, s).astype(np.float32)\n"
        "ps = rng.normal(1000, 15, s[1:]).astype(np.float32)\n"
        "m = np.full(s[1:], 4e-7, np.float32)\n"
        "out = run_derived_fields_np(tk, q, u, v, ps, np.zeros(2, np.float32),"
        " np.ones(2, np.float32), m, m, m, device='cpu')\n"
        "assert len(out) == 12 and out['th'][0, 2, 2] == np.float32(1e35)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        staging.run_derived_fields_np(*_inputs(), device="cuda")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_DEFAULT", tmp_path / "no-cuda")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(out_dir=tmp_path / "out")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("codec", ["native", "numpy"])
def test_codec_entries_match_numpy(codec, monkeypatch):
    """The native codec and its numpy fallback decode and re-encode like
    the sentinel predicate."""
    if codec == "numpy":
        monkeypatch.setattr(native, "_load", lambda: None)
    elif native.codec() != "native":
        pytest.skip("no C++ compiler: the native codec did not build")
    assert native.codec() == codec
    tk, q, *_ = _inputs(nlev=2, ny=5, nx=6, seed=2)
    tk[0, 1, 1] = np.nan
    ps_v, ps_m, n_ps = native.decode_pad(tk[1], 5, 6)
    np.testing.assert_array_equal(ps_m, tk[1] != np.float32(UNDEF))
    assert n_ps == int(ps_m.sum()) and np.all(ps_v[~ps_m] == 0.0)
    vals, mask, counts = native.decode_pad_batch([tk, q], 5, 6)
    ref_m = [~np.isnan(a) & (a != np.float32(UNDEF)) for a in (tk, q)]
    np.testing.assert_array_equal(mask, np.stack(ref_m))
    assert counts == [int(m.sum()) for m in ref_m]
    assert np.all(vals[~np.stack(ref_m)] == 0.0)
    outs = native.encode_trim_batch(vals, mask.view(np.uint8)[[1]], 5, 6,
                                    mask_map=(-1, 0))
    np.testing.assert_array_equal(outs[0], vals[0])
    np.testing.assert_array_equal(outs[1] == np.float32(UNDEF), ~ref_m[1])
