"""Read and write the JAX package's flat-npz checkpoints without JAX.

`heligym_tpu.utils.checkpoint.save_npz` stores a pytree as `leaf_0 ..
leaf_{n-1}` in `tree_flatten` order, `n`, and `treedef`, the string of its
PyTreeDef. The committed policies (`examples/*_policy.npz`) are whole
`TrainState`s. `load_train_state_npz` parses the treedef string, assigns
each leaf its place in the tree, and returns every part of the TrainState
(`load_policy_npz`: the network parameters, the observation statistics and
the counter); it fails loudly on a treedef it does not recognise.
`save_npz` writes a tree in the same format, its treedef string as JAX
renders it, so that the JAX package's `load_npz` reads the file back against
a template of the same structure. A tree is built of dicts, tuples, lists,
None, `Node`s, the port's state dataclasses (`EnvState`, `HeliState`, ...:
each the JAX struct of its name, its fields in order) and leaves (tensors,
numpy arrays, numbers).

`load_npz(path, template)` reads such a file, the JAX package's or the
port's, against a template tree such as an `EnvState`: the stored treedef
string, the leaf count and every leaf's shape must be the template's (each
mismatch raises `ValueError`, worded as the JAX package's), then each leaf
takes the template leaf's dtype and device. `save_pytree` and
`restore_pytree` are the port's counterparts of the JAX package's orbax
pair: the same flat dict in one `torch.save` file, read back with
`torch.load(weights_only=True)` and checked against the template in the
same way.

The JAX `EnvState` holds per-env PRNG keys after its counters; the port's
draws its noise from a `torch.Generator` and has none. A port `EnvState` is
written with zero keys (B, 2) uint32 in their place, and the keys a file
holds are checked for shape and dropped on reading.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

_TOKEN = re.compile(r"\s*(CustomNode\(|\*|'[^']*'|[\[\]\(\)\{\},:]|[A-Za-z_][\w\.]*)")


class TreedefError(ValueError):
    """The checkpoint's tree structure is not one this reader knows."""


def _tokens(text: str) -> List[str]:
    out, pos = [], 0
    while pos < len(text):
        if text[pos:].strip() == "":
            break
        m = _TOKEN.match(text, pos)
        if not m:
            raise TreedefError(f"cannot read the treedef at ...{text[pos:pos + 40]!r}")
        out.append(m.group(1))
        pos = m.end()
    return out


class _Parser:
    """Recursive descent over a PyTreeDef string. Nodes come out as
    ("leaf", index) | ("dict", {key: node}) | ("seq", [nodes]) |
    ("custom", name, [nodes]); leaves are numbered in flatten order."""

    def __init__(self, text: str):
        self.toks = _tokens(text)
        self.i = 0
        self.leaves = 0

    def peek(self) -> str:
        return self.toks[self.i] if self.i < len(self.toks) else ""

    def take(self, want: str = None) -> str:
        tok = self.peek()
        if tok == "" or (want is not None and tok != want):
            raise TreedefError(f"treedef: expected {want!r}, found {tok!r}")
        self.i += 1
        return tok

    def sequence(self, close: str) -> List[Any]:
        items = []
        while self.peek() != close:
            items.append(self.node())
            if self.peek() == ",":
                self.take(",")
        self.take(close)
        return items

    def node(self):
        tok = self.take()
        if tok == "*":
            self.leaves += 1
            return ("leaf", self.leaves - 1)
        if tok == "{":
            items = {}
            while self.peek() != "}":
                key = self.take()
                if not key.startswith("'"):
                    raise TreedefError(f"treedef: dict key {key!r} is not a string")
                self.take(":")
                items[key[1:-1]] = self.node()
                if self.peek() == ",":
                    self.take(",")
            self.take("}")
            return ("dict", items)
        if tok in ("(", "["):
            return ("seq", self.sequence(")" if tok == "(" else "]"))
        if tok == "CustomNode(":
            name = self.take()
            self.take("[")
            if name == "namedtuple":
                name = self.take()
            else:                       # skip the node's static data, e.g. "()"
                depth = 0
                while depth or self.peek() != "]":
                    t = self.take()
                    depth += (t in ("(", "[")) - (t in (")", "]"))
            self.take("]")
            self.take(",")
            self.take("[")
            children = self.sequence("]")
            self.take(")")
            return ("custom", name, children)
        raise TreedefError(f"treedef: unexpected {tok!r}")


def parse_treedef(text: str) -> Tuple[Any, int]:
    """(tree, number of leaves) of a PyTreeDef string."""
    text = text.strip()
    if not (text.startswith("PyTreeDef(") and text.endswith(")")):
        raise TreedefError(f"not a PyTreeDef string: {text[:60]!r}")
    parser = _Parser(text[len("PyTreeDef("):-1])
    tree = parser.node()
    if parser.peek() != "":
        raise TreedefError(f"treedef: trailing {parser.peek()!r}")
    return tree, parser.leaves


def _fill(node, leaves):
    kind = node[0]
    if kind == "leaf":
        return leaves[node[1]]
    if kind == "dict":
        return {k: _fill(v, leaves) for k, v in node[1].items()}
    if kind == "seq":
        return [_fill(v, leaves) for v in node[1]]
    return [_fill(v, leaves) for v in node[2]]


class Node:
    """A registered pytree node of the JAX package (a flax struct or a
    namedtuple) with its children in flatten order."""

    def __init__(self, name: str, children, namedtuple: bool = False):
        self.name, self.children, self.namedtuple = name, list(children), namedtuple


class _Keys:
    """The per-env PRNG keys of a JAX EnvState, which the port's lacks: a
    (B, 2) uint32 leaf, zeros when written, dropped when read."""

    def __init__(self, batch: Tuple[int, ...]):
        self.value = np.zeros(tuple(batch) + (2,), np.uint32)


def _children(node) -> List[Any]:
    """A dataclass's children in the JAX struct's order: its fields, and
    for an EnvState the keys after the counters."""
    from ..envs.env import EnvState

    names = [f.name for f in dataclasses.fields(node)]
    kids = [getattr(node, n) for n in names]
    if isinstance(node, EnvState):
        kids.insert(names.index("init"), _Keys(tuple(node.steps.shape)))
    return kids


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _walk(tree, leaf: Callable[[Any], None]) -> str:
    """The treedef string of `tree` as JAX renders it; `leaf(x)` is called
    on every leaf in `tree_flatten` order (dict keys sorted, sequences, a
    `Node`'s and a dataclass's children in order)."""
    def render(node) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {render(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, tuple):
            return "(" + ", ".join(render(v) for v in node) + \
                ("," if len(node) == 1 else "") + ")"
        if isinstance(node, list):
            return "[" + ", ".join(render(v) for v in node) + "]"
        if isinstance(node, Node):
            head = (f"namedtuple[{node.name}]" if node.namedtuple
                    else f"{node.name}[()]")
            return (f"CustomNode({head}, ["
                    + ", ".join(render(c) for c in node.children) + "])")
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return (f"CustomNode({type(node).__name__}[()], ["
                    + ", ".join(render(c) for c in _children(node)) + "])")
        if not (_is_leaf(node) or isinstance(node, _Keys)):
            raise TypeError(f"a checkpoint tree holds tensors, arrays and numbers, "
                            f"not {type(node).__name__}")
        leaf(node)
        return "*"

    return "PyTreeDef(" + render(tree) + ")"


def _host(x) -> np.ndarray:
    if isinstance(x, _Keys):
        return x.value
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten(tree) -> Tuple[str, List[np.ndarray]]:
    """(treedef string, leaves as numpy arrays) of `tree` as
    `jax.tree_util.tree_flatten` gives them."""
    leaves: List[np.ndarray] = []
    treedef = _walk(tree, lambda x: leaves.append(_host(x)))
    return treedef, leaves


def save_npz(path: str, tree, **extra) -> None:
    """Write `tree` in the flat-npz format; `extra` arrays ride beside the
    leaves under their own names (the JAX reader ignores them)."""
    treedef, leaves = flatten(tree)
    np.savez(path, n=len(leaves), treedef=treedef, **extra,
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})


def _cast(stored: np.ndarray, like):
    """A stored leaf as the template leaf `like`: its dtype, and for a
    tensor its device."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(stored)).to(
            device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        return np.asarray(stored).astype(like.dtype)
    return stored


_DROPPED = object()


def _rebuild(template, leaves):
    """`template` with its leaves replaced, in flatten order, from the
    iterator `leaves` (the stored keys of an EnvState consumed and
    dropped)."""
    if template is None:
        return None
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, leaves) for v in template)
    if isinstance(template, Node):
        return Node(template.name, [_rebuild(c, leaves) for c in template.children],
                    template.namedtuple)
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        names = [f.name for f in dataclasses.fields(template)]
        kids = [_rebuild(c, leaves) for c in _children(template)]
        return dataclasses.replace(template, **dict(zip(
            names, (k for k in kids if k is not _DROPPED))))
    stored, like = next(leaves)
    return _DROPPED if isinstance(like, _Keys) else _cast(stored, like)


def _restore(path: str, stored_treedef: str, leaves: List[np.ndarray], template):
    """`template` filled with the stored `leaves`, after checking the
    treedef, the leaf count and every leaf's shape against it."""
    t_leaves: List[Any] = []
    treedef = _walk(template, t_leaves.append)
    if stored_treedef != treedef:
        raise ValueError(
            f"checkpoint structure mismatch: {path} stores\n  {stored_treedef}\n"
            f"but the template is\n  {treedef}")
    if len(leaves) != len(t_leaves):
        raise ValueError(f"checkpoint leaf count {len(leaves)} != template "
                         f"{len(t_leaves)} ({path})")
    for i, (l, t) in enumerate(zip(leaves, t_leaves)):
        t_shape = tuple(t.shape) if isinstance(t, torch.Tensor) else np.shape(_host(t))
        if tuple(np.shape(l)) != t_shape:
            raise ValueError(f"checkpoint leaf {i} shape {np.shape(l)} != "
                             f"template {t_shape} ({path})")
    return _rebuild(template, iter(zip(leaves, t_leaves)))


def load_npz(path: str, template):
    """Inverse of `save_npz` (the port's or the JAX package's): the file's
    leaves in the structure of `template`, each with its template leaf's
    dtype and device. The stored treedef string, the leaf count and every
    leaf's shape are checked against `template`: a checkpoint of another
    configuration whose leaf count happens to be equal fails loudly instead
    of misassigning leaves."""
    with np.load(path, allow_pickle=False) as z:
        leaves = [z[f"leaf_{i}"] for i in range(int(z["n"]))]
        stored_treedef = str(z["treedef"])
    return _restore(path, stored_treedef, leaves, template)


def save_pytree(path: str, tree) -> None:
    """Save `tree` to the file `path` with `torch.save`: the flat dict of
    `save_npz` (`n`, `treedef`, `leaf_i` as CPU tensors)."""
    treedef, leaves = flatten(tree)
    torch.save({"n": len(leaves), "treedef": treedef,
                **{f"leaf_{i}": torch.from_numpy(np.ascontiguousarray(x))
                   for i, x in enumerate(leaves)}}, path)


def restore_pytree(path: str, template):
    """Restore a tree saved by `save_pytree` (`torch.load(weights_only=True)`);
    `template` supplies the structure, shapes, dtypes and devices (e.g. a
    freshly built EnvState), checked as `load_npz` checks them."""
    z = torch.load(path, map_location="cpu", weights_only=True)
    leaves = [z[f"leaf_{i}"].numpy() for i in range(int(z["n"]))]
    return _restore(path, str(z["treedef"]), leaves, template)


def load_train_state_npz(path: str) -> Dict[str, Any]:
    """Every part of a TrainState checkpoint as numpy arrays:
    {"treedef": str, "params": {"Dense_i": {"bias", "kernel"}, ...,
    "log_std"} (flax layout: kernel is (in, out)), "opt_state": {"count",
    "mu", "nu"} (optax's ScaleByAdamState, moments as flax dicts),
    "env_state": the flattened farm (`convert.STATE_KEYS`, "task_id" and the
    per-env "key"), "key", "update_count": int, "obs_stats": {"mean", "var",
    "count"}, "extra": the file's other arrays}. A reader that needs the
    exact structure (the learner) compares the treedef with its own."""
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n"])
        treedef = str(z["treedef"])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
        extra = {k: z[k] for k in z.files
                 if k not in ("n", "treedef") and not k.startswith("leaf_")}
    tree, count = parse_treedef(treedef)
    if count != n:
        raise TreedefError(f"{path}: treedef has {count} leaves, file has {n}")
    # TrainState: params, opt_state, env_state, key, update_count, obs_stats
    if not (tree[0] == "custom" and tree[1] == "TrainState" and len(tree[2]) == 6):
        raise TreedefError(f"{path}: not a TrainState checkpoint: {treedef[:80]}...")
    params_node, _, _, _, count_node, stats_node = tree[2]
    if not (stats_node[0] == "custom" and stats_node[1] == "ObsStats"
            and len(stats_node[2]) == 3 and count_node[0] == "leaf"
            and params_node[0] == "dict" and list(params_node[1]) == ["params"]):
        raise TreedefError(f"{path}: unexpected TrainState layout: {treedef[:80]}...")
    try:
        params, opt, env, key, upd, stats = _fill(tree, leaves)
        params = params["params"]
        (_empty, (cnt, mu, nu)) = opt
        heli, wind, dots, obs, wind_ned, steps, succ, env_key, init, task_id = env
        i_heli, i_wind, i_dots, i_obs, i_wind_ned = init
        flat = {"heli": np.stack(heli, -1), "wind": np.stack(wind, -1),
                "dots": np.stack(dots, -1), "obs": obs, "wind_ned": wind_ned,
                "steps": steps, "successed_steps": succ, "key": env_key,
                "init.heli": np.stack(i_heli, -1), "init.wind": np.stack(i_wind, -1),
                "init.dots": np.stack(i_dots, -1), "init.obs": i_obs,
                "init.wind_ned": i_wind_ned, "task_id": task_id}
        opt_state = {"count": cnt, "mu": mu["params"], "nu": nu["params"]}
    except (TypeError, ValueError, KeyError) as e:
        raise TreedefError(f"{path}: unexpected TrainState layout ({e}): "
                           f"{treedef[:80]}...") from e
    dense = sorted(k for k in params if k.startswith("Dense_"))
    if (set(params) != set(dense) | {"log_std"} or len(dense) % 2 or not dense
            or dense != sorted(f"Dense_{i}" for i in range(len(dense)))
            or any(set(params[k]) != {"bias", "kernel"} for k in dense)):
        raise TreedefError(f"{path}: unexpected network parameters {sorted(params)}")
    mean, var, s_count = stats
    return {"treedef": treedef, "params": params, "opt_state": opt_state,
            "env_state": flat, "key": key, "update_count": int(upd),
            "obs_stats": {"mean": mean, "var": var, "count": s_count},
            "extra": extra}


def load_policy_npz(path: str) -> Dict[str, Any]:
    """The policy of a committed TrainState checkpoint: the "params",
    "obs_stats" and "update_count" of `load_train_state_npz`."""
    ck = load_train_state_npz(path)
    return {k: ck[k] for k in ("params", "obs_stats", "update_count")}
