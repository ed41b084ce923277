"""The port's public surface against the JAX package's.

Every module of the JAX package is walked: each public module-level name
it defines (functions, classes, constants, and its ``__all__``) must
resolve in the port's namesake module, and each public method of each
public class in the port's namesake class (through the method order, so
that inherited methods count).  The names that live elsewhere in the
port, or have no meaning on Hopper, are listed below with their reasons;
a new JAX name that is neither found nor listed fails, and so does a
listed name that the JAX package no longer has.
"""

import ast
import importlib
import pathlib

import pytest

import go_audio_resampler_tpu as jar

JAX_ROOT = pathlib.Path(jar.__file__).resolve().parent
PORT = "go_audio_resampler_tpu_torch"

#: (JAX module, name) -> (port module, port name): the same surface under
#: another module or name.  Module paths are relative to the packages.
ELSEWHERE = {
    # pallas_fused.py's kernels and gate became the port's ops modules.
    ("ops.pallas_fused", "fused_resample_pallas"):
        ("ops.fused", "fused_resample"),           # K1
    ("ops.pallas_fused", "fused_resample_tmajor"):
        ("ops.tmajor", "fused_resample_tmajor"),   # K2
    ("ops.pallas_fused", "general_resample_pallas"):
        ("ops.general", "general_resample"),       # K3
    ("ops.pallas_fused", "mxu_dot"):
        ("ops.precision", "tiered_matmul"),        # the tiered product
    ("ops.pallas_fused", "DISPATCH_MODES"):
        ("ops.precision", "DISPATCH_MODES"),       # the gate's modes
    ("ops.pallas_fused", "PRECISION_MODES"):
        ("ops.precision", "PRECISION_MODES"),      # the tier names
    ("ops.pallas_fused", "dot_precision"):
        ("ops.precision", "dot_precision"),        # tier resolution
    ("ops.pallas_fused", "dispatch_for"):
        ("ops.precision", "dispatch_for"),         # per-call-site gate
    ("ops.pallas_fused", "dispatch_allowed"):
        ("ops.precision", "dispatch_allowed"),     # the tier-aware gate
    ("ops.pallas_fused", "force_xla"):
        ("ops.precision", "force_xla"),            # plain versions forced
}

_TILING = ("TPU tiling: the CUDA kernels pick their blocks from the "
           "operator (banded.tile_rows) and have no VMEM budget")

#: (JAX module, name) -> why the port has no counterpart.
NO_HOPPER = {
    ("ops.pallas_fused", "STREAM_TILE"): _TILING,
    ("ops.pallas_fused", "VMEM_BUDGET"): _TILING,
    ("ops.pallas_fused", "frame_tile_for"): _TILING,
    ("ops.pallas_fused", "choose_stream_tile"): _TILING,
    ("ops.pallas_fused", "vmem_bytes"): _TILING,
    ("ops.pallas_fused", "tmajor_vmem_bytes"): _TILING,
    ("ops.pallas_fused", "choose_tmajor_tile"): _TILING,
    ("ops.pallas_fused", "choose_tmajor_kf"): _TILING,
    ("ops.pallas_fused", "choose_general_tile"): _TILING,
    ("ops.pallas_fused", "general_vmem_bytes"): _TILING,
    ("engine.stages", "I32"): "a JAX dtype alias (jnp.int32); the port's "
                              "walk state is host integers",
    ("engine.tmajor", "I32"): "a JAX dtype alias (jnp.int32)",
}

#: JAX modules with no namesake in the port: every public name of each is
#: in ELSEWHERE or NO_HOPPER.
NO_NAMESAKE = {"ops.pallas_fused"}


def _modules() -> list[str]:
    """The JAX package's modules, relative to it ('' is the package)."""
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        rel = path.relative_to(JAX_ROOT).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        out.append(".".join(parts))
    return out


def _public(rel: str) -> tuple[set, dict]:
    """The public module-level names the JAX module defines (and its
    ``__all__``), and each public class's public methods."""
    mod = _import("go_audio_resampler_tpu", rel)
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names, methods = set(getattr(mod, "__all__", ())), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            methods[node.name] = {
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            names |= {n.id for t in node.targets for n in ast.walk(t)
                      if isinstance(n, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    names = {n for n in names if not n.startswith("_")}
    return names, {c: m for c, m in methods.items() if c in names}


def _import(pkg: str, rel: str):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


MODULES = _modules()


def test_the_walk_sees_every_module():
    assert len(MODULES) >= 39 and "" in MODULES
    assert {"engine.streaming", "ops.convolve", "ops.pallas_fused",
            "parallel.mesh"} <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r or "package")
def test_public_names_resolve_in_the_port(rel):
    names, methods = _public(rel)
    port = None if rel in NO_NAMESAKE else _import(PORT, rel)
    missing = []
    for name in sorted(names):
        if (rel, name) in NO_HOPPER:
            continue
        if (rel, name) in ELSEWHERE:
            where, alias = ELSEWHERE[(rel, name)]
            if not hasattr(_import(PORT, where), alias):
                missing.append(f"{name} -> {where}.{alias}")
            continue
        if port is None or not hasattr(port, name):
            missing.append(name)
            continue
        for meth in sorted(methods.get(name, ())):
            if not hasattr(getattr(port, name), meth):
                missing.append(f"{name}.{meth}")
    assert not missing, (f"go_audio_resampler_tpu.{rel or '__init__'}: not "
                         f"in the port and not listed: {missing}")


def test_listed_names_exist_in_the_jax_package():
    """Every entry of the mapping names a public JAX name, and a listed
    name is listed once."""
    assert not set(ELSEWHERE) & set(NO_HOPPER)
    for rel, name in list(ELSEWHERE) + list(NO_HOPPER):
        assert name in _public(rel)[0], (rel, name)
    for rel in NO_NAMESAKE:
        assert all((rel, n) in ELSEWHERE or (rel, n) in NO_HOPPER
                   for n in _public(rel)[0])


def test_ops_exports_match_jax():
    """The ``ops`` package exports the JAX package's names beside its
    kernels."""
    jops = importlib.import_module("go_audio_resampler_tpu.ops")
    tops = importlib.import_module(f"{PORT}.ops")
    assert set(jops.__all__) <= set(tops.__all__)
    for name in tops.__all__:
        assert getattr(tops, name) is not None
    assert tops.conv1d_poly is importlib.import_module(
        f"{PORT}.ops.convolve").conv1d_poly


def test_lowering_selection_is_public():
    """The surface this slice completes: EngineCore.core_fn and
    ops.set_conv_impl."""
    tar = importlib.import_module(PORT)
    assert callable(tar.EngineCore.core_fn)
    assert callable(importlib.import_module(f"{PORT}.ops").set_conv_impl)
