"""Read the JAX package's committed flat-npz checkpoints without JAX.

`heligym_tpu.utils.checkpoint.save_npz` stores a pytree as `leaf_0 ..
leaf_{n-1}` in `tree_flatten` order, `n`, and `treedef`, the string of its
PyTreeDef. The committed policies (`examples/*_policy.npz`) are whole
`TrainState`s. `load_policy_npz` parses the treedef string, assigns each leaf
its place in the tree, and returns the network parameters and the
observation statistics; it fails loudly on a treedef it does not recognise.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

import numpy as np

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


def load_policy_npz(path: str) -> Dict[str, Any]:
    """The policy of a committed TrainState checkpoint:
    {"params": {"Dense_i": {"bias", "kernel"}, ..., "log_std"},
     "obs_stats": {"mean", "var", "count"}, "update_count": int}
    as numpy arrays (flax layout: kernel is (in, out))."""
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n"])
        treedef = str(z["treedef"])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
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
    params = _fill(params_node, leaves)["params"]
    dense = sorted(k for k in params if k.startswith("Dense_"))
    if (set(params) != set(dense) | {"log_std"} or len(dense) % 2 or not dense
            or dense != sorted(f"Dense_{i}" for i in range(len(dense)))
            or any(set(params[k]) != {"bias", "kernel"} for k in dense)):
        raise TreedefError(f"{path}: unexpected network parameters {sorted(params)}")
    mean, var, cnt = _fill(stats_node, leaves)
    return {"params": params,
            "obs_stats": {"mean": mean, "var": var, "count": cnt},
            "update_count": int(leaves[count_node[1]])}
