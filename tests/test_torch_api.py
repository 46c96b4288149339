"""The port's public API against mve_tpu's, read from the source with ast.
Neither package is imported, so the test needs neither jax nor a card.

One case per module of mve_tpu. Each asserts that the module has a
counterpart in mve_tpu_torch (ops/pallas_matching.py maps to
ops/top2.py) and that, in the counterpart:
- every public top-level function and class of the reference exists,
  and every public method of a public class (with __init__ and
  __call__);
- every parameter of a reference function or method is a parameter of
  the port's, or the port's takes **kwargs;
- every annotated class attribute of a reference class (a dataclass's
  fields) is one of the port's class attributes;
- a package's __init__.py binds every public name the reference's binds
  (by definition, assignment or import).

DEPARTURES lists what the port does differently on purpose, each entry
with its reason and the record of it. test_departure_is_real fails when
an entry no longer names a difference, so the list cannot go stale.

Run alone: JAX_PLATFORMS=cpu python -m pytest tests/test_torch_api.py -q
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "mve_tpu", ROOT / "mve_tpu_torch"
RENAMED = {"ops/pallas_matching.py": "ops/top2.py"}

_ROADMAP = "ROADMAP.md C, Decided differently: the API departures"

# (module, name, what) -> (reason, record). `what` is "missing" (the
# function, class or method does not exist), "keyword <k>" or "field <f>".
DEPARTURES = {
    ("ops/pallas_matching.py", "descriptor_top2_pallas", "missing"): (
        "the Pallas kernel's wrapper; the port's kernel is called through "
        "ops/top2.top2 and ops/matching.descriptor_top2", _ROADMAP),
    ("mvs/pyramid.py", "ImagePyramidCache", "field _key"): (
        "id(scene) can be reused by a new scene; the port keys on a weak "
        "reference (_scene) and the embedding", "ROADMAP.md C, Found in the reference: ImagePyramidCache"),
    ("parallel/mesh.py", "get_mesh", "keyword axis_name"): (
        "the port's Mesh has one unnamed axis; a name would never be read", _ROADMAP),
    ("parallel/mesh.py", "shard_batch", "keyword axis_name"): (
        "the port's Mesh has one unnamed axis; a name would never be read", _ROADMAP),
    ("parallel/multihost.py", "global_mesh", "keyword axis_name"): (
        "the port's Mesh has one unnamed axis; a name would never be read", _ROADMAP),
    ("fssr/basis.py", "evaluate_pairs_indexed", "keyword num_segments_arr"): (
        "a (V,)-shaped dummy that fixes XLA's segment count; the port takes "
        "num_segments: int", _ROADMAP),
    ("fssr/iso_octree.py", "evaluate_at_positions", "keyword pair_chunk"): (
        "mve_tpu ignores it (del pair_chunk); the port's evaluation chunk is "
        "fixed", "CHANGES.md: fssr/iso_octree drops the pair_chunk option"),
    ("fssr/iso_octree.py", "IsoOctree.__init__", "keyword pair_chunk"): (
        "only stored and passed to evaluate_at_positions, which ignores it",
        "CHANGES.md: fssr/iso_octree drops the pair_chunk option"),
    ("mvs/solver.py", "solve_batch", "keyword chunk"): (
        "candidates scored at a time, a memory bound no caller sets; the "
        "port keeps it the constant rounds._CHUNK (8, mve_tpu's default)", _ROADMAP),
    ("mvs/sweep_solver.py", "solve_batch_sweep", "keyword chunk"): (
        "candidates scored at a time, a memory bound no caller sets; the "
        "port keeps it the constant rounds._CHUNK (8, mve_tpu's default)", _ROADMAP),
    ("sfm/ba/core.py", "solve_cameras_only", "keyword Jc"): (
        "unused in mve_tpu too: with the points fixed the system is B; the "
        "port takes (B, v, trr)", _ROADMAP),
    ("sfm/ba/core.py", "solve_cameras_only", "keyword cam_idx"): (
        "unused in mve_tpu too: with the points fixed the system is B; the "
        "port takes (B, v, trr)", _ROADMAP),
}

# Ported and to stay ported: none of these may become a departure.
NEVER_DEPARTURES = ("lm_min_iterations", "lm_optimize_device", "rect_margins", "margin_yx",
                    "rect_hw", "get_features_as_mesh", "verbose_output")

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _public(name):
    return not name.startswith("_")


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _class(node):
    methods, fields = {}, set()
    for b in node.body:
        if isinstance(b, _DEFS) and (_public(b.name) or b.name in ("__init__", "__call__")):
            methods[b.name] = _params(b)
        elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
            fields.add(b.target.id)
        elif isinstance(b, ast.Assign):
            fields.update(t.id for t in b.targets if isinstance(t, ast.Name))
    return methods, fields


def _surface(path):
    """(callables, classes, bound): public functions -> params, public
    classes -> (methods, fields), and every public name the module binds.
    A name assigned another function's name (an alias) takes its params."""
    tree = ast.parse(path.read_text())
    funcs, classes, bound = {}, {}, set()
    for node in tree.body:
        if isinstance(node, _DEFS):
            bound.add(node.name)
            if _public(node.name):
                funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            bound.add(node.name)
            if _public(node.name):
                classes[node.name] = _class(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    bound.add(t.id)
                    if isinstance(node.value, ast.Name) and node.value.id in funcs:
                        funcs[t.id] = funcs[node.value.id]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            bound.add(node.target.id)
    return funcs, classes, {n for n in bound if _public(n)}


def _keywords(name, ref, port):
    ref_names, _ = ref
    port_names, port_kwargs = port
    if port_kwargs:
        return set()
    return {(name, f"keyword {k}") for k in ref_names if k not in port_names}


def differences(rel):
    """Every (name, what) in which the port's counterpart of mve_tpu's
    module `rel` falls short of it."""
    ref_f, ref_c, ref_b = _surface(REF / rel)
    port_f, port_c, port_b = _surface(PORT / RENAMED.get(rel, rel))
    out = set()
    for name, params in ref_f.items():
        if name not in port_f:
            out.add((name, "missing"))
        else:
            out |= _keywords(name, params, port_f[name])
    for name, (methods, fields) in ref_c.items():
        if name not in port_c:
            out.add((name, "missing"))
            continue
        port_methods, port_fields = port_c[name]
        for m, params in methods.items():
            if m not in port_methods:
                out.add((f"{name}.{m}", "missing"))
            else:
                out |= _keywords(f"{name}.{m}", params, port_methods[m])
        out |= {(name, f"field {f}") for f in fields - port_fields}
    if rel.endswith("__init__.py"):
        out |= {(n, "missing") for n in ref_b - port_b - set(ref_f) - set(ref_c)}
    return out


MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def test_every_module_is_a_case():
    assert len(MODULES) > 100 and "sfm/ba/lm.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_module_api(rel):
    assert (PORT / RENAMED.get(rel, rel)).is_file(), f"no counterpart of mve_tpu/{rel}"
    departures = {(n, w) for (m, n, w) in DEPARTURES if m == rel}
    assert differences(rel) - departures == set()


@pytest.mark.parametrize("key", sorted(DEPARTURES), ids=lambda k: f"{k[0]}:{k[1]}:{k[2]}")
def test_departure_is_real(key):
    rel, name, what = key
    reason, record = DEPARTURES[key]
    assert reason and record.startswith(("ROADMAP.md", "CHANGES.md"))
    assert not {name.split(".")[-1], what.split()[-1]} & set(NEVER_DEPARTURES)
    assert (name, what) in differences(rel), f"{key} is no longer a difference"
