"""Parser for the Arnold .ass scene subset the reference testsuite uses.

The .ass format is the reference's de-facto scene/config format (SURVEY.md
section 5: scene files are node blocks of `key value` lines). This parser
covers every node type in testsuite/data/test_geo.ass and the per-case scene
files: options, persp_camera, quad/disk/skydome/point lights, polymesh with
b85-encoded arrays, shader nodes (rlGgx/rlDisney/rlSkin/standard/MayaFile/
projection/bump3d/MayaShadingEngine), filters and drivers, plus `include`.

Output is a flat list of `Node(type, params)` records with numpy arrays for
array params and string node-links left symbolic; scene assembly into SoA
device tables happens in `rlshaders_tpu.scene.build`.

Copied verbatim from rlshaders_tpu/scene/ass_parser.py: importing any
module of rlshaders_tpu imports jax, which the torch port must not need.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from . import b85

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")

_B85_TYPES = {"b85POINT", "b85VECTOR", "b85POINT2", "b85FLOAT", "b85UINT"}
_PLAIN_ARRAY_TYPES = {
    "POINT": 3,
    "VECTOR": 3,
    "POINT2": 2,
    "FLOAT": 1,
    "UINT": 1,
    "INT": 1,
    "BYTE": 1,
    "BOOL": 1,
    "RGB": 3,
    "RGBA": 4,
    "STRING": 1,
    "NODE": 1,
    "MATRIX": 16,
}
_ARITY = {
    "b85POINT": 3,
    "b85VECTOR": 3,
    "b85POINT2": 2,
    "b85FLOAT": 1,
    "b85UINT": 1,
}


@dataclass
class Node:
    type: str
    params: dict[str, Any] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.params.get("name", "")

    def get(self, key, default=None):
        return self.params.get(key, default)


def _is_number(tok: str) -> bool:
    return bool(_NUM_RE.match(tok))


def _tokenize(text: str):
    """Token stream: strips comments, keeps quoted strings as single tokens."""
    tokens = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        i = 0
        n = len(line)
        while i < n:
            c = line[i]
            if c.isspace():
                i += 1
                continue
            if c == '"':
                j = line.index('"', i + 1)
                tokens.append(("str", line[i + 1 : j]))
                i = j + 1
            elif c in "{}":
                tokens.append((c, c))
                i += 1
            else:
                j = i
                while j < n and not line[j].isspace() and line[j] not in "{}":
                    j += 1
                tokens.append(("tok", line[i:j]))
                i = j
    return tokens


class _Stream:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def done(self):
        return self.i >= len(self.toks)


def _convert_scalar(vals: list):
    """Numbers / on|off / strings -> python values."""
    out = []
    for kind, v in vals:
        if kind == "str":
            out.append(v)
        elif v == "on":
            out.append(True)
        elif v == "off":
            out.append(False)
        elif _is_number(v):
            out.append(float(v) if ("." in v or "e" in v or "E" in v) else int(v))
        else:
            out.append(v)  # node link (identifier)
    if len(out) == 1:
        return out[0]
    if all(isinstance(x, (int, float)) for x in out):
        return np.asarray(out, np.float32)
    return out


def _parse_array(s: _Stream, count: int, nkeys: int, atype: str):
    total = count * nkeys
    if atype in _B85_TYPES:
        arity = _ARITY[atype]
        # b85 blobs were split on whitespace into a run of tokens; consume
        # until the decoded payload is complete.
        if atype == "b85UINT":
            need_chars = None  # unknown due to RLE; decode incrementally
            blob = ""
            while True:
                kind, v = s.peek()
                if kind != "tok":
                    break
                blob += v
                s.next()
                try:
                    arr = b85.decode_uints(blob)
                except Exception:
                    continue
                if arr.size >= total:
                    return arr[:total].astype(np.int32)
            arr = b85.decode_uints(blob)
            return arr[:total].astype(np.int32)
        else:
            need_bytes = total * arity * 4
            blob = ""
            while True:
                kind, v = s.peek()
                if kind != "tok":
                    break
                blob += v
                s.next()
                # each char yields at most 4 bytes ('z'/'y' singles)
                if 4 * len(blob) < need_bytes:
                    continue
                arr = b85.decode_floats(blob)
                if arr.size >= total * arity:
                    break
            arr = b85.decode_floats(blob)[: total * arity]
            if arity > 1:
                arr = arr.reshape(total, arity)
            return arr
    arity = _PLAIN_ARRAY_TYPES[atype]
    if atype in ("STRING", "NODE"):
        vals = [s.next()[1] for _ in range(total)]
        return vals if total > 1 else vals
    raw = []
    for _ in range(total * arity):
        raw.append(float(s.next()[1]))
    arr = np.asarray(raw, np.float32)
    if atype in ("UINT", "INT", "BYTE"):
        arr = arr.astype(np.int32)
    if arity > 1:
        arr = arr.reshape(total, arity)
    return arr


def _parse_node(s: _Stream) -> Node:
    kind, ntype = s.next()
    assert kind == "tok", f"expected node type, got {kind} {ntype}"
    kind, brace = s.next()
    assert brace == "{", f"expected '{{' after {ntype}"
    node = Node(type=ntype)
    while True:
        kind, tok = s.next()
        if tok == "}":
            break
        pname = tok
        if pname == "declare":
            # declare <name> <class> <TYPE>  |  declare <name> <class> ARRAY <TYPE>
            s.next(), s.next()
            _, ty = s.next()
            if ty == "ARRAY":
                s.next()
            continue
        if pname == "matrix":
            # either 16 floats, or "matrix <n> <nkeys> MATRIX" (motion blur)
            k2, v2 = s.peek()
            k3, v3 = s.peek(1)
            k4, v4 = s.peek(2)
            if (
                _is_number(v2) and v2.isdigit() and k3 == "tok" and v3.isdigit()
                and k4 == "tok" and v4 == "MATRIX"
            ):
                s.next(), s.next(), s.next()
                count = int(v2) * int(v3)
                vals = [float(s.next()[1]) for _ in range(16 * count)]
                node.params["matrix"] = np.asarray(vals[:16], np.float32).reshape(4, 4)
            else:
                vals = [float(s.next()[1]) for _ in range(16)]
                node.params["matrix"] = np.asarray(vals, np.float32).reshape(4, 4)
            continue

        # Array parameter? <count> <nkeys> <TYPE>
        k2, v2 = s.peek()
        k3, v3 = s.peek(1)
        k4, v4 = s.peek(2)
        if (
            k2 == "tok"
            and v2 is not None
            and v2.isdigit()
            and k3 == "tok"
            and v3 is not None
            and v3.isdigit()
            and k4 == "tok"
            and (v4 in _B85_TYPES or v4 in _PLAIN_ARRAY_TYPES)
        ):
            s.next(), s.next(), s.next()
            node.params[pname] = _parse_array(s, int(v2), int(v3), v4)
            continue

        # Scalar / short-vector / link parameter: consume the first value
        # unconditionally, then keep consuming while tokens look like values.
        vals = [s.next()]
        while True:
            k2, v2 = s.peek()
            if k2 is None or v2 == "}":
                break
            if k2 == "str":
                vals.append(s.next())
            elif k2 == "tok" and (_is_number(v2) or v2 in ("on", "off")):
                vals.append(s.next())
            else:
                break
        node.params[pname] = _convert_scalar(vals)
    return node


def parse(path: str, _seen=None) -> list[Node]:
    """Parse a .ass file (following `include` directives) into node records."""
    _seen = _seen or set()
    path = os.path.abspath(path)
    if path in _seen:
        return []
    _seen.add(path)
    base = os.path.dirname(path)
    with open(path) as f:
        text = f.read()

    nodes: list[Node] = []
    s = _Stream(_tokenize(text))
    while not s.done():
        kind, tok = s.peek()
        if tok == "include":
            s.next()
            _, inc = s.next()
            # kick resolves includes against its working directory (the
            # testsuite root in runtest.py); search upward from the including
            # file's directory to emulate that.
            if os.path.isabs(inc):
                inc_path = inc
            else:
                inc_path = os.path.join(base, inc)
                d = base
                while not os.path.exists(inc_path):
                    parent = os.path.dirname(d)
                    if parent == d:
                        break
                    d = parent
                    inc_path = os.path.join(d, inc)
            nodes.extend(parse(inc_path, _seen))
        else:
            nodes.append(_parse_node(s))
    return nodes
