"""The port's public surface against the reference's, read from the source.

Both packages are parsed with ``ast`` and neither is imported.  One case per
module of ``src/repro``: its counterpart under ``src/repro_torch`` exists;
every public top-level name of the reference module resolves in the
counterpart, defined, imported or served by a module ``__getattr__``;
every public method or property of a class found in both exists on the
port's class (its bases followed through the port); every parameter of a
function or method found in both exists in the port's under the same name
with an equal default; and every ``add_argument`` flag of a reference
launcher exists in the port's.

What the port leaves out on purpose is listed once, in ``DEPARTURES``, each
with its reason.  A key is one of

- ``"param:<name>"`` - a parameter of that name, in any function;
- ``"default:<name>"`` - a default of a parameter of that name (the
  parameter itself exists);
- ``"name:<glob>"`` - a public top-level name matching the glob, in any
  module;
- ``"<module>:<name>"`` - one top-level name, class member
  (``Class.member``) or parameter (``function(param)``) of one module.

A reference module's public names are those it defines, and of those it
imports from inside the package only the ones it means to re-export: a
package ``__init__``'s, the ones its ``__all__`` lists, and the ones
``REEXPORTS`` names.  An import the reference needs only for its own code
is not surface, so the port's import lists are not tied to it.

The last cases fail on an entry no module needs, so the tables cannot rot.
"""
from __future__ import annotations

import ast
import fnmatch
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_TPU = "a TPU tiling or interpret knob: the CUDA kernels' tiles are fixed"
_MESH = ("a JAX sharding concept: the port runs on torch.distributed and "
         "its DeviceMesh")

DEPARTURES = {
    # the TPU kernels' knobs
    "param:interpret": "Pallas interpret mode; the port runs the plain "
                       "PyTorch version on CPU tensors instead",
    "param:queries_per_tile": _TPU,
    "param:rows_per_block": _TPU,
    "param:buckets_per_tile": _TPU,
    "param:lane_chunk": _TPU,
    "param:edges_per_tile": _TPU,
    "param:bags_per_block": _TPU,
    "param:block_q": _TPU,
    "param:block_k": _TPU,
    "param:use_commit_kernel": "the port's engine always commits through "
                               "its one commit kernel (kernel 2)",
    # JAX-only concepts
    "param:donate": "no buffer donation in torch: the engines update the "
                    "pool in place",
    "param:axis_name": _MESH,
    "param:shardings": "placement is a torch device, not a sharding",
    "param:key": "randomness comes from a torch.Generator (`generator`)",
    "models/transformer.py:LMConfig.scan_unroll":
        "the port's layer and chunk loops are Python loops; XLA's cost "
        "analysis is what needed unrolled scans",
    "param:unroll": "the port's chunk loop is a Python loop",
    "param:axis": "torch names it `dim`",
    "name:graph_pspecs": _MESH,
    "name:*_pallas": "the TPU kernels' names: each CUDA kernel has its own "
                     "wrapper (`*_cuda`) behind the same op",
    "kernels/flash_attention/kernel.py:flash_attention":
        "the Pallas kernel's own name: kernel 10 has one route, "
        "`ops.flash_attention`, over its wrapper `flash_attention_cuda`",
    "launch/dryrun.py:collective_stats": "parses XLA's HLO text; the port "
                                         "counts collectives in its trace",
    "launch/roofline.py:ICI_BW": "a TPU's inter-chip link; the H100 "
                                 "roofline's link is LINK_BW",
    "models/gnn/common.py:apply_mlp(act)": "jax.nn.silu there, F.silu "
                                           "here: the same function",
    # decided departures (ROADMAP section 3)
    "stream/maintenance.py:MaintenancePolicy.impl":
        "the maintenance kernels follow the pool's device",
    "algorithms/triangle.py:stream_property(impl)":
        "the count follows the pool's device",
    "algorithms/triangle.py:stream_property(chunk)":
        "the port sizes its buffers from the data",
    "models/transformer.py:prefill": "the LM is a class, TransformerLM, "
                                     "whose prefill writes its cache",
    "models/transformer.py:decode_step": "TransformerLM.decode_step "
                                         "writes its cache in place",
    "default:contrib_impl": "the port defaults to 'sweep' (kernel 3) so "
                            "the served numbers do not move; 'ref' runs "
                            "kernel 4",
}


#: names a reference module imports from elsewhere in the package that a
#: user imports from that module's path (not in its ``__all__``)
REEXPORTS = {
    "kernels/slab_update/ops.py": {"probe", "insert_edges_ref",
                                   "delete_edges_ref", "query_edges_ref"},
    "kernels/slab_intersect/ops.py": {"probe", "is_valid_vertex"},
    "kernels/slab_compact/ops.py": {"chain_order"},
    "algorithms/bfs.py": {"INF", "expand_vertices", "relax_edges"},
    "algorithms/pagerank.py": {"pool_edges", "SLAB_WIDTH"},
    "algorithms/wcc.py": {"updated_lane_mask"},
    "models/gnn/tensor_field.py": {"clebsch_gordan_real"},
    "resilience/guard.py": {"TOMBSTONE_KEY", "EMPTY_KEY", "INVALID_VERTEX"},
    "resilience/invariants.py": {"TOMBSTONE_KEY"},
}


def _py_files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


REF_MODULES = _py_files(REF)


# ---------------------------------------------------------------------------
# reading a module
# ---------------------------------------------------------------------------

def _top_statements(body):
    """Top-level statements, looking inside ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _top_statements(node.body)
            yield from _top_statements(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody,
                         *[h.body for h in node.handlers]):
                yield from _top_statements(part)
        else:
            yield node


def _targets(node):
    """Names an assignment binds (not those it subscripts or reads)."""
    out = []
    todo = list(node.targets if isinstance(node, ast.Assign)
                else [node.target])
    while todo:
        t = todo.pop()
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            todo += t.elts
        elif isinstance(t, ast.Starred):
            todo.append(t.value)
    return out


def _internal_base(path: Path, node: ast.ImportFrom):
    """The package directory an import from inside the package reads,
    or None for an import from outside it."""
    if node.level:
        base = path.parent
        for _ in range(node.level - 1):
            base = base.parent
    elif (node.module or "").split(".")[0] in ("repro", "repro_torch"):
        base = ROOT / "src"
    else:
        return None
    for part in (node.module or "").split("."):
        if part:
            base = base / part
    return base


def _is_module(base: Path, name: str) -> bool:
    return (base / f"{name}.py").is_file() or (base / name).is_dir()


class Module:
    """What ``ast`` says of one file: its top-level names (``defined``:
    name -> node; ``imported``: names imported from inside the package),
    the names every import binds, the names its ``__all__`` lists and the
    names a module ``__getattr__`` serves."""

    def __init__(self, path: Path):
        self.init = path.name == "__init__.py"
        self.tree = ast.parse(path.read_text())
        self.defined, self.imported, self.bound = {}, set(), set()
        for node in _top_statements(self.tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                self.defined[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                for name in _targets(node):
                    self.defined.setdefault(name, node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.bound.add((a.asname or a.name).split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = _internal_base(path, node)
                for a in node.names:
                    name = a.asname or a.name
                    self.bound.add(name)
                    # a name imported from inside the package, not a module
                    if base is not None and not _is_module(base, a.name):
                        self.imported.add(name)
        self.lazy = self._lazy_names()
        node = self.defined.get("__all__")
        self.all = set() if node is None else {
            c.value for c in ast.walk(node.value)
            if isinstance(c, ast.Constant) and isinstance(c.value, str)}

    def _lazy_names(self) -> set:
        """String constants a module ``__getattr__`` compares ``name`` with,
        directly or through a tuple or set bound at top level."""
        fn = self.defined.get("__getattr__")
        if not isinstance(fn, ast.FunctionDef):
            return set()
        out = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                out.add(n.value)
            if isinstance(n, ast.Name) and n.id in self.defined:
                src = self.defined[n.id]
                for c in ast.walk(src):
                    if isinstance(c, ast.Constant) and isinstance(c.value,
                                                                  str):
                        out.add(c.value)
        return out

    def public(self, reexports=frozenset()) -> set:
        """Names defined here, and the imported ones a package
        ``__init__``, ``__all__`` or ``reexports`` makes public."""
        shown = self.imported if self.init else \
            self.imported & (self.all | set(reexports))
        return {n for n in set(self.defined) | shown
                if not n.startswith("_")}

    def resolves(self, name: str) -> bool:
        return name in self.defined or name in self.bound or \
            name in self.lazy


_CACHE = {}


def module(root: Path, rel: str) -> Module:
    key = (root, rel)
    if key not in _CACHE:
        _CACHE[key] = Module(root / rel)
    return _CACHE[key]


def _members(cls: ast.ClassDef) -> dict:
    """name -> node of a class body's functions and assigned names."""
    out = {}
    for node in _top_statements(cls.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for name in _targets(node):
                out.setdefault(name, node)
    return out


def _port_classes() -> dict:
    """Every class of the port by name (for following bases)."""
    if "classes" not in _CACHE:
        out = {}
        for rel in _py_files(PORT):
            for name, node in module(PORT, rel).defined.items():
                if isinstance(node, ast.ClassDef):
                    out.setdefault(name, []).append(node)
        _CACHE["classes"] = out
    return _CACHE["classes"]


def _port_members(cls: ast.ClassDef, seen=None) -> dict:
    seen = set() if seen is None else seen
    if id(cls) in seen:
        return {}
    seen.add(id(cls))
    out = {}
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else \
            getattr(base, "id", None)
        for node in _port_classes().get(name, []):
            out.update(_port_members(node, seen))
    out.update(_members(cls))
    return out


#: array libraries whose dtype attributes name one dtype in both packages
_DTYPE_ROOTS = ("jnp", "np", "numpy", "torch")


def _default_text(node):
    if isinstance(node, ast.Attribute) and getattr(
            node.value, "id", None) in _DTYPE_ROOTS:
        return "<dtype>." + node.attr
    try:
        return repr(ast.literal_eval(node))
    except ValueError:
        return ast.unparse(node)


def _params(fn) -> dict:
    """name -> default text (None when it has none) of a function."""
    a = fn.args
    out = {}
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for arg, d in zip(pos, defaults):
        out[arg.arg] = None if d is None else _default_text(d)
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        out[arg.arg] = None if d is None else _default_text(d)
    for extra in (a.vararg, a.kwarg):
        if extra is not None:
            out["*" + extra.arg] = None
    return out


def _flags(mod: Module) -> set:
    out = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == \
                "add_argument":
            out |= {a.value for a in n.args if isinstance(a, ast.Constant)
                    and str(a.value).startswith("-")}
    return out


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _departure(rel: str, kind: str, name: str, used: set):
    """The DEPARTURES key that excuses gap ``name`` of ``kind`` in module
    ``rel`` (and marks it used), or None."""
    keys = [f"{rel}:{name}"]
    if kind == "name":
        keys += [k for k in DEPARTURES if k.startswith("name:")
                 and fnmatch.fnmatchcase(name, k[5:])]
    elif kind == "param":
        keys.append("param:" + name.rsplit("(", 1)[1].rstrip(")"))
    elif kind == "default":
        keys.append("default:" + name.rsplit("(", 1)[1].rstrip(")"))
    for k in keys:
        if k in DEPARTURES:
            used.add(k)
            return k
    return None


def _compare_function(ref_fn, port_fn, qual: str, gaps: list):
    rp, pp = _params(ref_fn), _params(port_fn)
    for p, d in rp.items():
        if p.startswith("*"):
            continue
        if p not in pp:
            gaps.append(("param", f"{qual}({p})"))
        elif d is not None and d != pp[p]:
            gaps.append(("default", f"{qual}({p})"))


def surface_gaps(rel: str, used: set) -> list:
    """The reference module ``rel``'s public surface the port's
    counterpart lacks, as ``(kind, what)``; departures left out."""
    if not (PORT / rel).is_file():
        return [("module", rel)]
    ref, port = module(REF, rel), module(PORT, rel)
    gaps = []
    for name in sorted(ref.public(REEXPORTS.get(rel, ()))):
        if not port.resolves(name):
            gaps.append(("name", name))
    for name, node in sorted(ref.defined.items()):
        if name.startswith("_") or name not in port.defined:
            continue
        other = port.defined[name]
        if isinstance(node, ast.ClassDef) and isinstance(other,
                                                         ast.ClassDef):
            theirs = _port_members(other)
            for m, mnode in sorted(_members(node).items()):
                if m.startswith("_") and m != "__init__":
                    continue
                if m not in theirs:
                    if m != "__init__" and isinstance(
                            mnode, (ast.FunctionDef, ast.AsyncFunctionDef,
                                    ast.AnnAssign)):
                        gaps.append(("member", f"{name}.{m}"))
                    continue
                if isinstance(mnode, ast.FunctionDef) and isinstance(
                        theirs[m], ast.FunctionDef):
                    _compare_function(mnode, theirs[m], f"{name}.{m}", gaps)
        elif isinstance(node, ast.FunctionDef) and isinstance(
                other, ast.FunctionDef):
            _compare_function(node, other, name, gaps)
    if rel.startswith("launch/"):
        for flag in sorted(_flags(ref) - _flags(port)):
            gaps.append(("flag", flag))
    return [g for g in gaps if _departure(rel, g[0], g[1], used) is None]


@pytest.mark.parametrize("rel", REF_MODULES)
def test_port_surface_matches_reference(rel):
    gaps = surface_gaps(rel, set())
    assert not gaps, f"{rel}: the port lacks {gaps}"


def test_departures_are_all_needed():
    used = set()
    for rel in REF_MODULES:
        surface_gaps(rel, used)
    stale = sorted(set(DEPARTURES) - used)
    assert not stale, f"DEPARTURES entries no module needs: {stale}"
    assert all(r.strip() for r in DEPARTURES.values())


def test_reexports_are_reference_imports():
    # each REEXPORTS name is one the reference module imports and does not
    # already make public by __all__
    stale = sorted((rel, n) for rel, names in REEXPORTS.items()
                   for n in names
                   if n not in module(REF, rel).imported
                   or n in module(REF, rel).all)
    assert not stale, f"REEXPORTS entries that are not re-exports: {stale}"


def test_reference_modules_found():
    # the walk reads the reference's whole package
    assert len(REF_MODULES) >= 90 and "stream/store.py" in REF_MODULES
