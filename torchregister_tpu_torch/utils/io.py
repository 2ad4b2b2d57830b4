"""Transform (de)serialization (counterpart of ``torchregister_tpu/utils/io.py``).

Files are the JAX package's: an ``.npz`` with the leaves as ``leaf_<i>`` and
the tree structure as ``__treedef__``, the bytes of JAX's
``PyTreeDef.serialize_using_proto()``. Transforms are flat dicts of string
keys to arrays, so this module reads and writes exactly that subset of the
format without JAX: leaves in sorted key order, and a treedef message of one
leaf node per key followed by one dict node (kind 5) whose keys index a
string table. Anything else raises ``ValueError``. A file written here loads
with the JAX package's ``load_pytree`` and the reverse.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_LEAF, _DICT = 1, 5  # PyTreeDef node kinds


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _int_field(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value) if value else b""  # proto3 omits 0


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_dict_treedef(keys) -> bytes:
    """JAX's proto treedef bytes of a flat dict with these (sorted) keys."""
    keys = list(keys)
    leaf = _bytes_field(1, _int_field(2, _LEAF))
    node = _int_field(1, len(keys)) + _int_field(2, _DICT)
    if keys:
        node += _bytes_field(3, _bytes_field(1, b"".join(_varint(i)
                                                          for i in range(len(keys)))))
    strings = b"".join(_bytes_field(2, k.encode()) for k in keys)
    return leaf * len(keys) + _bytes_field(1, node) + strings


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated treedef")
        byte = buf[i]
        i += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, i


def _fields(buf: bytes):
    """``(field, wire_type, value)`` of a protobuf message; value is an int
    (wire type 0) or bytes (wire type 2). Raises on anything else."""
    out, i = [], 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 2:
            n, i = _read_varint(buf, i)
            if i + n > len(buf):
                raise ValueError("truncated treedef")
            value, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported treedef wire type {wire}")
        out.append((field, wire, value))
    return out


def decode_dict_treedef(buf: bytes) -> list[str]:
    """Keys, in leaf order, of a flat-dict treedef; ``ValueError`` for any
    other tree structure."""
    nodes, strings = [], []
    for field, wire, value in _fields(buf):
        if (field, wire) == (1, 2):
            nodes.append(value)
        elif (field, wire) == (2, 2):
            strings.append(value.decode())
        else:
            raise ValueError("not a flat dict of arrays: unexpected treedef field")
    if not nodes:
        raise ValueError("empty treedef")
    for node in nodes[:-1]:
        if _fields(node) != [(2, 0, _LEAF)]:
            raise ValueError("not a flat dict of arrays: a leaf node is not a plain leaf")
    arity, kind, idx = 0, 0, []
    for field, wire, value in _fields(nodes[-1]):
        if (field, wire) == (1, 0):
            arity = value
        elif (field, wire) == (2, 0):
            kind = value
        elif (field, wire) == (3, 2):
            for f, w, packed in _fields(value):
                if (f, w) != (1, 2):
                    raise ValueError("not a flat dict of arrays: unexpected dict keys")
                pos = 0
                while pos < len(packed):
                    v, pos = _read_varint(packed, pos)
                    idx.append(v)
        else:
            raise ValueError("not a flat dict of arrays: unexpected node field")
    if kind != _DICT or arity != len(nodes) - 1 or len(idx) != arity:
        raise ValueError("not a flat dict of arrays")
    if any(i >= len(strings) for i in idx):
        raise ValueError("treedef key index out of range")
    return [strings[i] for i in idx]


def save_pytree(path: str, tree: Mapping) -> str:
    """Save a flat dict of string keys to arrays (tensors or numpy) as
    ``path`` (``.npz`` appended when missing, as ``np.savez`` would); returns
    the path written."""
    if not isinstance(tree, Mapping) or not all(isinstance(k, str) for k in tree):
        raise ValueError("save_pytree takes a flat dict of string keys to arrays")
    if not path.endswith(".npz"):
        path = path + ".npz"
    keys = sorted(tree)
    arrays = {}
    for i, k in enumerate(keys):
        v = tree[k]
        if isinstance(v, Mapping):
            raise ValueError(f"save_pytree takes a flat dict; {k!r} holds a dict")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = np.asarray(v)
    arrays["__treedef__"] = np.frombuffer(encode_dict_treedef(keys), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load_pytree(path: str) -> dict:
    """Load a flat dict of numpy arrays written by either package."""
    with np.load(path, allow_pickle=False) as data:
        keys = decode_dict_treedef(data["__treedef__"].tobytes())
        n = len([k for k in data.files if k.startswith("leaf_")])
        if n != len(keys):
            raise ValueError(f"{path}: {n} leaves for {len(keys)} keys")
        return {k: data[f"leaf_{i}"] for i, k in enumerate(keys)}


def save_transform(path: str, register) -> str:
    """Persist a fitted ``Register``'s transform: a flow field under
    ``flow``, a matrix under ``theta``, with the ``mode`` manifest."""
    if register.theta is None:
        raise ValueError("Register has no fitted transform to save")
    key = "flow" if register.mode == "flow" else "theta"
    return save_pytree(path, {"mode": np.asarray(register.mode), key: register.theta})


def load_transform(path: str, register) -> None:
    """Restore a transform saved with :func:`save_transform` into
    ``register`` (on its device). A saved mode the register would misapply
    (a flow into rigid/affine or the reverse), and a composite cascade
    transform (theta and flow), raise ``ValueError``."""
    tree = load_pytree(path)
    has_theta, has_flow = "theta" in tree, "flow" in tree
    if has_theta and has_flow:
        raise ValueError(
            f"{path} stores a composite cascade transform (theta AND flow); a "
            "Register holds a single transform. Apply it with the CLI "
            "(`python -m torchregister_tpu_torch apply`), which chains matrix then flow.")
    saved_mode = str(tree.get("mode", ""))
    if not saved_mode or saved_mode == "cascade":
        # mode-less and single-component cascade files: infer from the payload
        saved_mode = "flow" if has_flow else ("rigid" if has_theta else "")
    matrixish = ("rigid", "affine")
    compatible = saved_mode == register.mode or (
        saved_mode in matrixish and register.mode in matrixish)
    if saved_mode and not compatible:
        raise ValueError(
            f"{path} stores a {saved_mode!r} transform; this Register is "
            f"mode={register.mode!r} and would misapply it. Construct "
            f"Register(mode={saved_mode!r}) to load it.")
    payload = tree.get("flow", tree.get("theta"))
    if payload is None:
        raise ValueError(f"{path}: no theta/flow entry in transform file")
    register.theta = torch.tensor(payload, dtype=torch.float32, device=register.device)
