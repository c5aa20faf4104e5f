"""The port's public surface covers the reference's.

Every module of ``meshfem_tpu`` is read with ``ast`` (nothing of it is
imported).  Each public function and class in it must have a counterpart
of the same name reachable from the mirrored module of
``meshfem_tpu_torch`` (``meshfem_tpu/fem/quadrature.py`` ->
``meshfem_tpu_torch.fem.quadrature``, defined or imported there), and each
public method of a class a method of that name on the counterpart class,
unless the name stands in ``RENAMED`` (its counterpart lives under
another name or module) or in ``LAYOUT_ONLY`` (a TPU layout or a JAX
mechanism the port replaces by design, each with its reason).
"""

import ast
import importlib
import pathlib

import pytest

REF = pathlib.Path(__file__).resolve().parent.parent / "meshfem_tpu"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

# reference name -> the port's "module::name" that does its work
RENAMED = {
    "utils/timer.py::jax_profile_trace":
        "meshfem_tpu_torch.utils.timer::torch_profile_trace",
    "sparse/contract.py::qp_contract":
        "meshfem_tpu_torch.kernels::qp_contract",
    "sparse/contract.py::factored_contract":
        "meshfem_tpu_torch.kernels::factored_contract",
}

_ROUTE = ("the lane-routing plans of the TPU gather and segment sum; "
          "kernels A and B (sparse/scatter.py GatherPlan, ScatterPlan, "
          "RoutedEBE.build) replace them")
_LADDER = ("the routed operator's TPU scatter ladder and planes wrapper "
           "(lanes of 128); kernel B's CSR plan replaces them")
_PACKED = ("the packed 128-lane slot layout of the structured operator; "
           "the port applies in channels (NDHWC) only")

# "module::name" (or "module::Class.method") -> why the port has none
LAYOUT_ONLY = {
    "sparse/route.py::CopyPlan": _ROUTE,
    "sparse/route.py::ReducePlan": _ROUTE,
    "sparse/route.py::pack_to_device": _ROUTE,
    "sparse/route.py::plan_copy": _ROUTE,
    "sparse/route.py::copy_plan_structure": _ROUTE,
    "sparse/route.py::plan_copy_cells": _ROUTE,
    "sparse/route.py::plan_reduce": _ROUTE,
    "sparse/routed_ebe.py::SumPlan": _LADDER,
    "sparse/routed_ebe.py::SumPlanTiles": _LADDER,
    "sparse/routed_ebe.py::PlanesOp": _LADDER,
    "ops/structured.py::StructuredP2Elasticity.pack_slots": _PACKED,
    "ops/structured.py::StructuredP2Elasticity.apply_packed": _PACKED,
    "ops/structured.py::StructuredP2Elasticity.to_packed": _PACKED,
    "ops/structured.py::StructuredP2Elasticity.from_packed": _PACKED,
    "ops/structured.py::StructuredP2Elasticity.valid_mask_packed": _PACKED,
    "ops/structured.py::StructuredP2Elasticity.diagonal_packed": _PACKED,
    "ops/structured_mg.py::packed_to_channels": _PACKED,
    "ops/structured_mg.py::channels_to_packed": _PACKED,
    "kernels/element_stiffness.py::element_stiffness_pallas":
        "the Pallas launcher of _asm_kernel; its counterpart is kernel E, "
        "meshfem_tpu_torch.kernels.element_stiffness",
    "parallel/sharded.py::ShardedEBE.apply_fn":
        "a pure function for jit / pjit with stored shardings; the port's "
        "ShardedEBE applies through __call__ over its comm",
}
# methods of any class: JAX pytree registration, which torch has no use for
LAYOUT_ONLY_METHODS = {
    "tree_flatten": "JAX pytree registration",
    "tree_unflatten": "JAX pytree registration",
}


def _public(path):
    """[(name, [public method names] or None)] of a reference module."""
    tree = ast.parse((REF / path).read_text())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and not node.name.startswith("_"):
            methods = None
            if isinstance(node, ast.ClassDef):
                methods = [m.name for m in node.body
                           if isinstance(m, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
                           and not m.name.startswith("_")]
            out.append((node.name, methods))
    return out


def _port_module(path):
    name = "meshfem_tpu_torch." + ".".join(
        pathlib.PurePosixPath(path).with_suffix("").parts)
    return name[:-len(".__init__")] if name.endswith(".__init__") else name


def _resolve(target):
    module, name = target.split("::")
    return getattr(importlib.import_module(module), name, None)


@pytest.mark.parametrize("path", MODULES)
def test_public_names_have_counterparts(path):
    missing = []
    names = _public(path)
    needed = [n for n, _ in names if f"{path}::{n}" not in LAYOUT_ONLY
              and f"{path}::{n}" not in RENAMED]
    module = None
    if needed or any(m for _, m in names):
        try:
            module = importlib.import_module(_port_module(path))
        except ModuleNotFoundError:
            if needed:
                pytest.fail(f"no port module for {path}: {needed}")
    for name, methods in names:
        key = f"{path}::{name}"
        if key in LAYOUT_ONLY:
            continue
        obj = _resolve(RENAMED[key]) if key in RENAMED \
            else getattr(module, name, None)
        if obj is None:
            missing.append(name)
            continue
        for m in methods or ():
            if m in LAYOUT_ONLY_METHODS or f"{key}.{m}" in LAYOUT_ONLY:
                continue
            if not hasattr(obj, m):
                missing.append(f"{name}.{m}")
    assert not missing, f"{path}: no counterpart in the port for {missing}"


def test_exemptions_name_reference_names():
    """Every entry of the lists names a public reference name, every
    renamed counterpart exists, and every reason is given."""
    public = {}
    for path in MODULES:
        for name, methods in _public(path):
            public[f"{path}::{name}"] = methods or []
    for key, why in LAYOUT_ONLY.items():
        path, name = key.split("::")
        name, _, method = name.partition(".")
        base = f"{path}::{name}"
        assert base in public, key
        assert not method or method in public[base], key
        assert why
    for key, target in RENAMED.items():
        assert key in public, key
        assert _resolve(target) is not None, target
    assert len(MODULES) > 80


EXPERIMENTS = REF.parent / "experiments"
# the reference's TPU measurement harnesses, which the port does not carry
# (their one Pallas kernel, probe_route.py's, is the port's kernel F,
# meshfem_tpu_torch.kernels.route_window)
TPU_PROBES = {
    "ab_session.py": "an A/B timing session of the TPU",
    "fill_probe.py": "a fill-rate probe of the TPU",
    "probe_apply_ab.py": "a TPU apply timing probe",
    "probe_contract.py": "a TPU contraction timing probe",
    "probe_route.py": "the TPU lane-routing probe; its kernel is F",
    "probe_routed_bench.py": "a TPU routed-operator timing probe",
    "probe_routed_stages.py": "a TPU routed-stage timing probe",
    "probe_scat_blk.py": "a TPU scatter timing probe",
    "probe_scat_grp.py": "a TPU scatter timing probe",
    "probe_structured_n.py": "a TPU structured-operator timing probe",
    "probe_tpu.py": "a TPU device probe",
}
SCRIPTS = sorted(p.name for p in EXPERIMENTS.glob("*.py")
                 if p.name not in TPU_PROBES)


@pytest.mark.parametrize("script", SCRIPTS)
def test_experiment_functions_have_counterparts(script):
    """Each public function of a validation script under ``experiments/``
    has a counterpart of the same name in
    ``meshfem_tpu_torch.experiments.<script>``."""
    tree = ast.parse((EXPERIMENTS / script).read_text())
    names = [n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]
    module = importlib.import_module(
        "meshfem_tpu_torch.experiments." + script[:-len(".py")])
    assert names
    missing = [n for n in names if not callable(getattr(module, n, None))]
    assert not missing, f"{script}: no counterpart in the port for {missing}"


def test_experiment_exemptions_are_the_probes():
    """The exempted scripts exist, each with its reason, and the rest are
    the eight validation suites."""
    have = {p.name for p in EXPERIMENTS.glob("*.py")}
    assert set(TPU_PROBES) <= have and all(TPU_PROBES.values())
    assert len(SCRIPTS) == 8
