"""The one table of the kernel library's C entries (``_build._SIGNATURES``)
against the ``extern "C"`` blocks of ``csrc/*.cu``.

ctypes passes what the table says, whatever the C code takes: an ``int``
declared where the entry takes an ``int64_t`` truncates without a word,
and a parameter too few or too many shifts every one after it.  So every
exported ``mf_*`` entry is held here to exactly one line of the table,
parameter by parameter, and the table to nothing else."""

import ctypes
import re
from types import SimpleNamespace

import pytest

from cuda_host import CSRC
from mi_fieldcalc_tpu_torch import _build

#: ``<return type> mf_name(<parameters>) {`` inside an ``extern "C"`` block
_ENTRY = re.compile(r"^(int|const char\*)\s+(mf_\w+)\(([^)]*)\)\s*\{",
                    re.MULTILINE)


def _exported() -> dict:
    """Every ``mf_*`` entry of the ``extern "C"`` blocks of ``csrc/*.cu``:
    name -> (return type, [parameter kinds])."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for block in re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"',
                                src.read_text(), re.DOTALL):
            block = re.sub(r"//[^\n]*", "", block)
            for ret, name, params in _ENTRY.findall(block):
                assert name not in out, f"{name} is exported twice"
                out[name] = (ret, [_c_kind(p) for p in params.split(",")])
    return out


def _c_kind(param: str) -> str:
    *ty, name = param.replace("*", " * ").split()
    if name == "stream":
        return "stream"
    if "*" in ty:
        return "pointer"
    return {"int": "int", "int64_t": "int64", "float": "float"}[" ".join(ty)]


def _ctypes_kind(t) -> str:
    if t is _build._Stream:
        return "stream"
    if t is ctypes.c_void_p or issubclass(t, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_int64: "int64",
            ctypes.c_float: "float"}.get(t, repr(t))


def _mismatches(table: dict, exported: dict) -> list:
    """What keeps ``table`` from declaring ``exported`` exactly."""
    out = [f"{n}: not in the table" for n in exported if n not in table]
    out += [f"{n}: not exported" for n in table if n not in exported]
    for name in sorted(set(table) & set(exported)):
        want = exported[name][1]
        got = [_ctypes_kind(t) for t in table[name]]
        if got != want:
            out.append(f"{name}: table {got}, C {want}")
    return out


EXPORTED = _exported()


@pytest.mark.parametrize("name", sorted(EXPORTED))
def test_each_entry_is_declared_once_as_the_source_takes_it(name):
    """One line of the table a C entry, its argument types the C
    parameters one for one (an ``int64_t`` a ``c_int64``, the stream its
    own slot), and its return type as declared."""
    source = (CSRC.parent / "_build.py").read_text()
    assert source.count(f'"{name}":') == 1
    assert _mismatches({name: _build._SIGNATURES[name]},
                       {name: EXPORTED[name]}) == []
    fn = getattr(_build._declare(SimpleNamespace(**{
        name: SimpleNamespace()})), name)
    ret = ctypes.c_char_p if EXPORTED[name][0] == "const char*" \
        else ctypes.c_int
    assert fn.restype is ret and fn.argtypes == _build._SIGNATURES[name]


def test_the_table_declares_every_entry_and_no_other():
    """The parse finds every source's entries (of a block it failed to
    read it would find none, and hold nothing), and the table is them."""
    assert len(EXPORTED) == 14 and {
        "mf_derived_fields", "mf_vertical_interp", "mf_hlevel_suite",
        "mf_vessel_icing_modstall", "mf_probe_solver", "mf_ensemble_prob",
        "mf_error_string"} <= set(EXPORTED)
    assert _mismatches(_build._SIGNATURES, EXPORTED) == []


#: one fault planted in a copy of the table: entry, its new argument types
#: from the true ones (None: left out), and what the check then says
PLANTED = {
    "int for int64_t": ("mf_ensemble_stats",
                        lambda s: s[:8] + [ctypes.c_int] + s[9:], "table"),
    "one short": ("mf_derived_fields", lambda s: s[:-1], "table"),
    "stream moved": ("mf_vertical_interp", lambda s: s[:-2] + s[:-3:-1],
                     "table"),
    "stray": ("mf_gone", lambda s: [ctypes.c_int], "not exported"),
    "left out": ("mf_probe_window", lambda s: None, "not in the table")}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_the_guard_fails_on_a_planted_mismatch(fault):
    """A copy of the table with one fault planted fails the check, which
    names the entry."""
    name, edit, found = PLANTED[fault]
    table = dict(_build._SIGNATURES)
    table[name] = edit(table.get(name))
    if table[name] is None:
        del table[name]
    got = _mismatches(table, EXPORTED)
    assert got and all(g.startswith(f"{name}: {found}") for g in got), got
