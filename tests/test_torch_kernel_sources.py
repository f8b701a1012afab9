"""The CUDA kernel sources of the port, read as text: what the CPU can check
of kernels it cannot compile. Every source names the Pallas kernel it
replaces, no source sums with atomics (bit-identical continuation needs a
fixed summation order), the Hopper kernels really issue wgmma and TMA
loads, and each plain-C entry point takes exactly the arguments its
ctypes binding passes — an ABI drift would otherwise show only as a crash
on the card."""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from grit_tpu_torch.ops import build

REPO = Path(__file__).resolve().parent.parent
PALLAS = REPO / "grit_tpu" / "ops" / "flash_attention.py"
SOURCES = sorted(build.CSRC.glob("*.cu"))
HEADERS = sorted(build.CSRC.glob("*.cuh"))
HOPPER = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _code(path: Path) -> str:
    """The source without its comments."""
    text = re.sub(r"/\*.*?\*/", " ", path.read_text(), flags=re.DOTALL)
    return re.sub(r"//[^\n]*", " ", text)


def _functions(code: str) -> dict[str, str]:
    """Function name -> body, for every definition in ``code``."""
    out = {}
    head = re.compile(r"(?:__device__|__global__|__host__|static|inline)"
                      r"[^;{}]*?\b((?!__)\w+)\s*\([^;{}]*\)\s*\{")
    for m in head.finditer(code):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(code[i], 0)
            i += 1
        out[m.group(1)] = code[m.end():i - 1]
    return out


def _helpers_reaching(ptx: str) -> set[str]:
    """Header functions whose body issues ``ptx`` or calls one that does."""
    bodies = {}
    for h in HEADERS:
        bodies.update(_functions(_code(h)))
    found = {name for name, body in bodies.items() if ptx in body}
    grew = True
    while grew:
        more = {name for name, body in bodies.items() if name not in found
                and any(re.search(rf"\b{f}\s*[<(]", body) for f in found)}
        found |= more
        grew = bool(more)
    return found


def test_every_source_is_built_and_bound():
    assert {p.stem for p in SOURCES} == set(build.SOURCES) == set(
        build._ARGTYPES)


@pytest.mark.parametrize("src", SOURCES, ids=lambda p: p.name)
def test_source_names_the_pallas_kernel_it_replaces(src):
    m = re.search(r"grit_tpu/ops/flash_attention\.py:(\w+)", src.read_text())
    assert m, f"{src.name} names no Pallas kernel"
    pallas = PALLAS.read_text()
    assert re.search(rf"^def {m.group(1)}\(", pallas, re.MULTILINE)
    assert re.search(rf"pl\.pallas_call\(\s*functools\.partial\(\s*"
                     rf"{m.group(1)}\b", pallas), (
        f"{m.group(1)} is not a kernel that pl.pallas_call launches")


@pytest.mark.parametrize("src", SOURCES + HEADERS, ids=lambda p: p.name)
def test_no_source_sums_with_atomics(src):
    code = _code(src)
    for pattern in (r"\batomic\w*\s*\(", r"\batom\.", r"\bred\.",
                    r"cp\.reduce"):
        assert not re.search(pattern, code), f"{src.name}: {pattern}"


@pytest.mark.parametrize("stem", HOPPER)
@pytest.mark.parametrize("ptx", ["wgmma.mma_async", "cp.async.bulk.tensor",
                                 "mbarrier.try_wait", "setmaxnreg"])
def test_hopper_kernels_issue_wgmma_tma_and_mbarriers(stem, ptx):
    helpers = _helpers_reaching(ptx)
    assert helpers, f"no helper in {[h.name for h in HEADERS]} issues {ptx}"
    kernel = _functions(_code(build.CSRC / f"{stem}.cu"))[f"{stem}_kernel"]
    called = {f for f in helpers if re.search(rf"\b{f}\s*[<(]", kernel)}
    assert called, f"{stem}_kernel reaches no {ptx} (helpers: {helpers})"


@pytest.mark.parametrize("stem", build.SOURCES)
def test_c_entry_signature_matches_ctypes_argtypes(stem):
    m = re.search(r'extern "C" int (\w+)\(([^)]*)\)',
                  _code(build.CSRC / f"{stem}.cu"))
    assert m, f"{stem}.cu has no extern \"C\" entry"
    name, argtypes = build._ARGTYPES[stem]
    assert m.group(1) == name
    params = [p.strip() for p in m.group(2).split(",")]
    want = [{build._P: "pointer", build._I: "int", build._F: "float"}[a]
            for a in argtypes]
    got = ["pointer" if "*" in p else p.split()[0] for p in params]
    assert got == want, f"{name}({', '.join(params)}) vs ctypes {want}"
