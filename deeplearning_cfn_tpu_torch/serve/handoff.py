"""KV-block handoff artifact for disaggregated prefill/decode serving.

A prefill replica finishes admission prefill (encoder pass + the one
decode-step decoder fill over the paged path) and parks the request; the
router then moves the stream to a decode replica by shipping this
artifact — the minimal state a different engine needs to resume
token-by-token decode bit-identically:

- ``row_block_index`` ``[width, max_blocks]`` int32: each beam row's
  block table as indices into the artifact's unique-block list (-1 =
  unbound). Shared prefix blocks appear ONCE in the block list and are
  referenced from several rows — the importer re-shares them (refcount)
  instead of copying.
- ``kv_<i>``: for the i-th paged KV pool leaf (deterministic tree-leaf
  order), the unique blocks gathered as ``[n_unique, H, block, D]``.
  Exporting whole blocks means the tail block carries positions above
  the decode pos; that garbage is harmless by the engine's
  write-before-attend invariant (overwritten before it can be attended).
- ``enc`` / ``src_mask``: encoder output + source mask for the row
  (beam rows share one source).
- ``src_ids`` / ``tokens`` / ``prev`` / ``pos``: the prompt, tokens
  emitted so far (prefill emits exactly one), each row's last token and
  decode position.
- beam state (``scores`` / ``beam_done`` / ``beam_tokens``) when
  width > 1.
- ``meta`` int64 ``[version, width, steps, budget, kv_block_size,
  model_max_len, max_src_len, enc_hid]`` and ``deadline`` float64
  (NaN = none): the compatibility contract — an importer with a
  different block size or model geometry must refuse, not misdecode.

Transport reuses the ckpt store codecs (``put_npz``/``get_npz``), so
the artifact moves over whatever Store the fleet already trusts for
weights — memory in-process, POSIX across hosts — and its wire size is
measurable with ``get_bytes``.

A copy of the JAX package's ``serve/handoff.py`` with one change: a bfloat16
leaf (the port's KV pool and encoder table in bf16) is a ``torch.Tensor``,
since numpy has no bfloat16 of its own. It crosses the codec exactly as the
JAX package ships its ``ml_dtypes`` arrays — a uint8 byte view plus a
``_dtype_<key>`` tag ``"bfloat16"`` — and decodes through torch, so the
bytes of either package load in the other and ``ml_dtypes`` is never
imported. Every other leaf is a numpy array.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Extension dtypes numpy cannot hold without ml_dtypes: the codec's tag
# (``str`` of the ml_dtypes dtype) -> the torch dtype that decodes it.
_TORCH_EXTENSION_DTYPES = {"bfloat16": torch.bfloat16}
_TAG_OF_TORCH = {v: k for k, v in _TORCH_EXTENSION_DTYPES.items()}

HANDOFF_VERSION = 1


class HandoffCorruptError(ValueError):
    """The stored artifact failed to decode or validate — a torn write,
    a codec-level bit flip, or a truncated object. The importer must
    REJECT it (never misdecode); the exporter still holds the parked
    prefill state, so the router retries the hop next tick. A *missing*
    artifact raises ``FileNotFoundError`` instead — same recovery, but
    loss and corruption are counted apart."""

# meta[] slot names, in order (see module docstring).
META_FIELDS = ("version", "width", "steps", "budget", "kv_block_size",
               "model_max_len", "max_src_len", "enc_hid")


def pack_meta(**fields) -> np.ndarray:
    """Build the int64 meta vector from keyword fields (all required)."""
    missing = set(META_FIELDS) - set(fields)
    if missing:
        raise ValueError(f"meta fields missing: {sorted(missing)}")
    return np.asarray([int(fields[k]) for k in META_FIELDS], np.int64)


def unpack_meta(meta: np.ndarray) -> Dict[str, int]:
    meta = np.asarray(meta).reshape(-1)
    if meta.shape[0] != len(META_FIELDS):
        raise ValueError(
            f"handoff meta has {meta.shape[0]} fields, expected "
            f"{len(META_FIELDS)}")
    return {k: int(v) for k, v in zip(META_FIELDS, meta)}


def validate_artifact(artifact: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Structural validation; returns the unpacked meta dict."""
    for key in ("meta", "row_block_index", "enc", "src_mask", "src_ids",
                "tokens", "prev", "pos", "deadline"):
        if key not in artifact:
            raise ValueError(f"handoff artifact missing {key!r}")
    meta = unpack_meta(artifact["meta"])
    if meta["version"] != HANDOFF_VERSION:
        raise ValueError(
            f"handoff artifact version {meta['version']} != "
            f"{HANDOFF_VERSION}")
    w = meta["width"]
    if artifact["row_block_index"].shape[0] != w:
        raise ValueError(
            f"row_block_index has {artifact['row_block_index'].shape[0]} "
            f"rows, meta says width {w}")
    if w > 1:
        for key in ("scores", "beam_done", "beam_tokens"):
            if key not in artifact:
                raise ValueError(
                    f"beam handoff artifact missing {key!r}")
    n_unique = None
    i = 0
    while f"kv_{i}" in artifact:
        blocks = artifact[f"kv_{i}"]
        if n_unique is None:
            n_unique = blocks.shape[0]
        elif blocks.shape[0] != n_unique:
            raise ValueError("kv_* leaves disagree on unique block count")
        i += 1
    if i == 0:
        raise ValueError("handoff artifact has no kv_* leaves")
    bound = artifact["row_block_index"]
    if n_unique is not None and bound.size and bound.max() >= n_unique:
        raise ValueError(
            f"row_block_index references block {int(bound.max())}, only "
            f"{n_unique} exported")
    return meta


def kv_leaf_count(artifact: Dict[str, np.ndarray]) -> int:
    n = 0
    while f"kv_{n}" in artifact:
        n += 1
    return n


def _encode_extension_dtypes(artifact) -> Dict[str, np.ndarray]:
    """npz cannot round-trip extension arrays — a bfloat16 cache comes back
    as raw void records (``|V2``). Ship such arrays (torch bfloat16 tensors,
    or numpy arrays of an extension dtype) as uint8 byte views plus a
    per-key ``_dtype_<key>`` tag; everything numpy-native passes through
    untouched."""
    out: Dict[str, np.ndarray] = {}
    for k, a in artifact.items():
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
            tag = _TAG_OF_TORCH.get(a.dtype)
            if tag is None:
                out[k] = a.numpy()
                continue
            out[k] = a.contiguous().view(torch.uint8).numpy()
            out[f"_dtype_{k}"] = np.frombuffer(tag.encode("ascii"),
                                               np.uint8)
            continue
        a = np.asarray(a)
        if a.dtype.kind not in "biufc":
            out[k] = np.ascontiguousarray(a).view(np.uint8)
            out[f"_dtype_{k}"] = np.frombuffer(
                str(a.dtype).encode("ascii"), np.uint8)
        else:
            out[k] = a
    return out


def decode_extension_array(raw, tag: str) -> torch.Tensor:
    """A uint8 byte view (last axis 2x the element count) and its dtype tag
    -> the torch tensor it encodes."""
    dtype = _TORCH_EXTENSION_DTYPES.get(tag)
    if dtype is None:
        raise ValueError(f"unsupported extension dtype tag {tag!r}")
    raw = np.ascontiguousarray(np.asarray(raw).view(np.uint8))
    return torch.from_numpy(raw.copy()).view(dtype)


def as_tensor(a) -> torch.Tensor:
    """An artifact leaf as a CPU torch tensor: torch tensors pass through,
    numpy-native arrays convert, and a numpy array of an extension dtype
    (what the JAX package's ``export_handoff`` returns in bf16) is read
    through its bytes."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.kind not in "biufc":
        return decode_extension_array(a.view(np.uint8), str(a.dtype))
    return torch.from_numpy(np.ascontiguousarray(a))


def _decode_extension_dtypes(artifact) -> Dict[str, object]:
    tags = {k[len("_dtype_"):]: bytes(np.asarray(v)).decode("ascii")
            for k, v in artifact.items() if k.startswith("_dtype_")}
    out: Dict[str, object] = {}
    for k, a in artifact.items():
        if k.startswith("_dtype_"):
            continue
        if k in tags:
            a = decode_extension_array(a, tags[k])
        out[k] = a
    return out


def save_handoff(store, key: str, artifact: Dict[str, np.ndarray]) -> int:
    """Serialize the artifact through the ckpt store codec; returns the
    wire size in bytes (what actually crossed the transport)."""
    validate_artifact(artifact)
    store.put_npz(key, _encode_extension_dtypes(artifact))
    return len(store.get_bytes(key))


def load_handoff(store, key: str) -> Dict[str, np.ndarray]:
    """Decode + validate an artifact previously saved with
    :func:`save_handoff`.

    Any decode or validation failure is wrapped into
    :class:`HandoffCorruptError` — the npz container's per-member CRC32
    catches payload bit flips as a ``BadZipFile``, and
    :func:`validate_artifact` catches structurally-plausible-but-wrong
    state; both mean "reject, leave the exporter parked, retry". A
    missing object (``FileNotFoundError``) passes through untouched so
    loss stays distinguishable from corruption."""
    try:
        artifact = _decode_extension_dtypes(store.get_npz(key))
        validate_artifact(artifact)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise HandoffCorruptError(
            f"handoff artifact {key!r} is corrupt: {e}") from e
    return artifact


def drop_handoff(store, key: str) -> None:
    """Best-effort cleanup once the decode side has imported the blocks
    (the store codec has no single-key delete; prefix delete is exact
    here because handoff keys are unique per attempt)."""
    try:
        store.delete_prefix(key)
    except Exception:
        pass
