"""Every public top-level function and class of every module of the JAX
package has a same-named counterpart in the port's module at the same
relative path, outside a short list of exceptions, each with its reason; and
the two packages' CLIs take the same flags with the same defaults and
choices, apart from the port's ``--device``.

The JAX modules are read with ``ast``, not imported; the port's are imported
and the name looked up on the module."""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = "analysisgnn_tpu", "analysisgnn_tpu_torch"

# (JAX module, name) -> (port module, port name, reason); port name None: no counterpart
EXCEPTIONS = {
    ("kernels/pallas_segment.py", "tile_edge_offsets"): (
        "kernels/segment_mean.py", "row_pointers",
        "the Pallas kernels' tile offsets; the CUDA kernels take CSR row pointers of the sorted ids"),
    ("kernels/pallas_segment.py", "segment_mean_base_sorted"): (
        "kernels/segment_mean.py", "segment_mean_base", "K1's wrapper (csrc/segment_mean_base.cu)"),
    ("kernels/pallas_segment.py", "segment_sum_sorted"): (
        "kernels/segment_sum.py", "segment_sum_sorted", "K4's wrapper (the sum mode of K1's kernel)"),
    ("kernels/pallas_segment.py", "segment_softmax_sorted"): (
        "kernels/segment_softmax.py", "segment_softmax_sorted", "K5's wrapper (csrc/segment_softmax.cu)"),
    ("kernels/pallas_segment.py", "segment_softmax_agg_sorted"): (
        "kernels/softmax_agg.py", "segment_softmax_agg", "K2's wrapper (csrc/segment_softmax_agg.cu)"),
    ("kernels/pallas_relmm.py", "relation_weighted_matmul"): (
        "kernels/relmm.py", "relation_weighted_matmul", "K3's wrapper (csrc/relation_weighted_matmul.cu)"),
    ("kernels/halo.py", "halo_pull_pallas"): (
        "kernels/halo.py", "halo_pull", "K6's wrapper (csrc/halo_pull.cu)"),
    ("distributed/partition_encoder.py", "halo_pull"): (
        "kernels/halo.py", "halo_pull", "the ppermute halo pull is K6 in the port"),
    ("models/fused.py", "unify_node_types"): (
        None, None, "no caller in either package; a port of it was removed for that reason"),
    ("cli/predict.py", "load_model_and_params"): (
        "cli/predict.py", "load_model", "reads Orbax; the port's checkpoint is <tag>.pt, read by load_model"),
    ("data/native.py", "get_library"): (
        None, None, "the JAX builder's silent numpy fallback; the port's native builder refuses instead"),
    ("data/native.py", "native_available"): (
        None, None, "the JAX builder's silent numpy fallback; the port's native builder refuses instead"),
}


def _module_name(pkg, rel):
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([pkg] + parts)


def _jax_public_names():
    out = []
    for path in sorted((REPO / JAX_PKG).rglob("*.py")):
        rel = path.relative_to(REPO / JAX_PKG).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
                out.append((rel, node.name))
    return out


JAX_NAMES = _jax_public_names()


def test_the_jax_package_is_walked_whole():
    modules = {rel for rel, _ in JAX_NAMES}
    assert len(JAX_NAMES) >= 320 and len(modules) >= 63
    assert {"data/synth_dlc.py", "data/download.py", "utils/profiling.py", "kernels/segment_ops.py"} <= modules
    assert set(EXCEPTIONS) <= set(JAX_NAMES)


@pytest.mark.parametrize("rel", sorted({rel for rel, _ in JAX_NAMES}))
def test_every_public_name_has_a_counterpart(rel):
    names = [name for r, name in JAX_NAMES if r == rel]
    missing = []
    for name in names:
        port_rel, port_name, reason = EXCEPTIONS.get((rel, name), (rel, name, None))
        if port_rel is None:
            assert reason
            continue
        module = importlib.import_module(_module_name(PORT_PKG, port_rel))
        if not hasattr(module, port_name):
            missing.append(f"{rel}::{name} -> {port_rel}::{port_name}")
    assert not missing, missing


def test_kernels_package_exports_the_jax_names():
    jax_init = ast.parse((REPO / JAX_PKG / "kernels" / "__init__.py").read_text())
    (jall,) = [n.value for n in jax_init.body if isinstance(n, ast.Assign) and n.targets[0].id == "__all__"]
    names = [ast.literal_eval(e) for e in jall.elts]
    kernels = importlib.import_module(f"{PORT_PKG}.kernels")
    ops = importlib.import_module(f"{PORT_PKG}.kernels.segment_ops")
    assert kernels.__all__ == names and len(names) == 8
    for name in names:
        assert getattr(kernels, name) is getattr(ops, name), name
    # the wrapper modules of the same names stay reachable by their full path
    k1 = importlib.import_module(f"{PORT_PKG}.kernels.segment_mean")
    assert callable(k1.segment_mean_base) and kernels.segment_mean is ops.segment_mean


def _actions(parser):
    return {a.dest: (a.default, a.choices, tuple(a.option_strings), a.nargs, type(a).__name__)
            for a in parser._actions}


@pytest.mark.parametrize("cli", ["predict", "train"])
def test_cli_flags_equal_the_jax_cli(cli):
    jax_cli = importlib.import_module(f"{JAX_PKG}.cli.{cli}")
    port_cli = importlib.import_module(f"{PORT_PKG}.cli.{cli}")
    jax_actions, port_actions = _actions(jax_cli.get_parser()), _actions(port_cli.get_parser())
    assert set(port_actions) - set(jax_actions) == {"device"}
    assert set(jax_actions) <= set(port_actions)
    for dest, action in jax_actions.items():
        assert port_actions[dest] == action, dest
    if cli == "predict":
        assert jax_actions["artifacts_dir"][0] == "./artifacts/models"
