"""Shim unpickler for the reference's pickled ``CounterKmerIndex`` files.

A copy of ``kmer_mapper_tpu/index/pickled.py`` (loading into this package's
:class:`~kmer_mapper_tpu_torch.index.kmer_index.KmerIndex`), pinned by
``tests/test_torch_index_forms.py``.

The reference's index resolution falls back to
``shared_memory_wrapper.from_file(path)`` — a plain pickle load — and requires
the result to be a ``graph_kmer_index.CounterKmerIndex``
(``kmer_mapper/util.py:63-66``). Those pickles reference class paths from
``graph_kmer_index`` / ``npstructures`` / ``shared_memory_wrapper``, none of
which exist here; this module loads them anyway by substituting **inert stub
classes** for those modules' types and then harvesting the numpy payload:

* the counter's unique keys (``counter._keys``, possibly wrapped in an
  npstructures ``RaggedArray``/``HashTable`` — any uint64 arrays reachable
  under a ``_keys`` attribute are concatenated),
* optional per-entry ``_kmers``/``_nodes`` arrays (used by the reference's
  ``get_node_counts()`` to turn kmer counts into node counts,
  ``command_line_interface.py:133-138``).

Only class paths from an allowlist of those packages are stubbed; numpy's own
reconstruction machinery is delegated to real numpy, and anything else raises
— a pickle can otherwise execute arbitrary code.
"""
from __future__ import annotations

import io
import logging
import pickle

import numpy as np

logger = logging.getLogger(__name__)

_STUB_PREFIXES = ("graph_kmer_index", "npstructures", "shared_memory_wrapper", "kmer_mapper")
# the only real callables a numpy-array pickle needs for reconstruction —
# allowing all of numpy.* would expose e.g. numpy.ctypeslib.load_library
_NUMPY_ALLOWED = {
    "_reconstruct",  # numpy.core.multiarray / numpy._core.multiarray
    "scalar",
    "ndarray",
    "dtype",
    "_frombuffer",
    "_DType_reconstruct",
}


class _Stub:
    """Inert stand-in for an external class: accepts any constructor args and
    records all state for later harvesting."""

    _module = _qualname = "?"

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self.__dict__.update(kwargs)

    @classmethod
    def _new(cls, *args):
        # classmethod-style reconstructors (e.g. from_dict) map here too
        obj = cls.__new__(cls)
        obj._stub_args = args
        return obj

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2 and isinstance(state[1], dict):
            self.__dict__.update(state[1])  # (slots-less, dict) protocol form
        else:
            self._stub_state = state


def _make_stub(module: str, name: str) -> type:
    return type(name, (_Stub,), {"_module": module, "_qualname": name})


class ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "numpy":
            if name in _NUMPY_ALLOWED:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"refusing to unpickle numpy callable {module}.{name}"
            )
        if any(module.startswith(p) for p in _STUB_PREFIXES):
            return _make_stub(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} (not a known index class)"
        )


def _walk(obj, seen: set, path: str = ""):
    """Yield (attr_path, value) over the stub/numpy object graph."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, _Stub):
        items = list(obj.__dict__.items())
        items += [(f"arg{i}", a) for i, a in enumerate(getattr(obj, "_stub_args", ()))]
        for key, val in items:
            sub = f"{path}.{key}" if path else str(key)
            yield sub, val
            yield from _walk(val, seen, sub)
    elif isinstance(obj, (list, tuple)):
        for i, val in enumerate(obj):
            sub = f"{path}[{i}]"
            yield sub, val
            yield from _walk(val, seen, sub)
    elif isinstance(obj, dict):
        for key, val in obj.items():
            sub = f"{path}[{key!r}]"
            yield sub, val
            yield from _walk(val, seen, sub)


_PAYLOAD_ATTRS = ("_data", "data", "arg0")  # RaggedArray-style wrappers


def _arrays_under(root, marker: str) -> list[np.ndarray]:
    """ndarrays that *are* a ``marker`` attribute, or sit directly under one
    behind a known payload attribute (RaggedArray ``_data``); structural
    metadata (shapes, offsets, mod) next to the payload is skipped."""
    out = []
    for path, val in _walk(root, set()):
        if not (isinstance(val, np.ndarray) and val.size):
            continue
        parts = path.replace("[", ".").replace("]", "").split(".")
        if marker in parts:
            tail = parts[parts.index(marker) + 1 :]
            if all(t in _PAYLOAD_ATTRS or t.isdigit() for t in tail):
                out.append(val)
    return out


def load_pickled_index(path_or_file):
    """Load any reference pickle-file index form -> KmerIndex.

    The reference's dependency ``shared_memory_wrapper.to_file`` writes plain
    pickles (its files are conventionally *named* ``.npz`` without being zip
    archives), and two reference paths read them:

    * ``_get_kmer_index_from_args``'s fallback (``kmer_mapper/util.py:63-66``)
      — a pickled ``CounterKmerIndex``;
    * ``IndexBundle.from_file(path).indexes["kmer_index"]``
      (``kmer_mapper/util.py:51-53``) — a pickled bundle object/dict whose
      ``kmer_index`` member is a full ``KmerIndex`` or ``CounterKmerIndex``.

    Both are handled: the object graph is searched for the kmer index
    (directly, or under a ``kmer_index`` path inside a bundle), then its
    arrays are harvested — counter ``_keys`` and/or per-entry
    ``_kmers``/``_nodes``/``_frequencies``.
    """
    if hasattr(path_or_file, "read"):
        obj = ShimUnpickler(path_or_file).load()
    else:
        with open(path_or_file, "rb") as f:
            obj = ShimUnpickler(f).load()
    if isinstance(obj, (_Stub, dict)):
        target = _find_kmer_index_obj(obj)
        if target is not None:
            return _index_from_stub(target)
    raise ValueError(f"pickle did not contain an index object: {type(obj)}")


def _looks_like_index(obj) -> bool:
    if not isinstance(obj, _Stub):
        return False
    d = obj.__dict__
    return (
        "counter" in d
        or "_keys" in d
        or ("_kmers" in d and "_nodes" in d)
        or isinstance(d.get("_stub_state"), np.ndarray)
    )


def _find_kmer_index_obj(root):
    """The kmer index inside a pickled object graph: the root itself if it is
    index-shaped, else the first index-shaped subobject reached under a
    ``kmer_index`` attribute/dict-key path (an IndexBundle carries many
    indexes; only the kmer index is ours). The match is on an exact path
    SEGMENT — a bundle member like ``reverse_kmer_index`` that happens to
    carry ``_kmers``/``_nodes`` arrays must not be harvested instead."""
    if _looks_like_index(root):
        return root
    for path, val in _walk(root, set()):
        segments = [
            s.strip("'\"")
            for s in path.replace("[", ".").replace("]", "").split(".")
        ]
        if "kmer_index" in segments and _looks_like_index(val):
            return val
    return None


def _index_from_stub(obj):
    from .kmer_index import KmerIndex

    key_arrays = _arrays_under(obj, "_keys")
    if not key_arrays:
        # full KmerIndex form (no counter): per-entry arrays only
        kmers = obj.__dict__.get("_kmers")
        nodes = obj.__dict__.get("_nodes")
        freqs = obj.__dict__.get("_frequencies")
        if isinstance(kmers, np.ndarray) and isinstance(nodes, np.ndarray):
            logger.info(
                "loaded pickled %s.%s: %d (kmer, node) entries",
                obj._module,
                obj._qualname,
                len(kmers),
            )
            return KmerIndex.from_entries(
                kmers.astype(np.uint64),
                np.asarray(nodes).astype(np.int64).astype(np.int32),
                frequencies=(
                    np.asarray(freqs).astype(np.uint16)
                    if isinstance(freqs, np.ndarray) and len(freqs) == len(kmers)
                    else None
                ),
            )
    if not key_arrays:
        raise ValueError(
            f"no counter keys found in pickled {obj._module}.{obj._qualname}"
        )
    keys = np.unique(np.concatenate([a.reshape(-1).astype(np.uint64) for a in key_arrays]))
    kmers = getattr(obj, "_kmers", None)
    nodes = getattr(obj, "_nodes", None)
    logger.info(
        "loaded pickled %s.%s: %d unique counter keys%s",
        obj._module,
        obj._qualname,
        len(keys),
        "" if nodes is None else f", {len(np.asarray(nodes))} node entries",
    )
    if (
        isinstance(kmers, np.ndarray)
        and isinstance(nodes, np.ndarray)
        and len(kmers) == len(nodes)
        and len(kmers)
    ):
        # counter keys absent from the entries stay probeable/countable (they
        # just map to no node), so counter semantics survive the conversion
        missing = np.setdiff1d(keys, np.unique(kmers.astype(np.uint64)))
        if len(missing):
            logger.warning(
                "%d counter keys have no (kmer, node) entry; counting them only",
                len(missing),
            )
        return KmerIndex.from_entries(
            kmers.astype(np.uint64),
            nodes.astype(np.int64).astype(np.int32),
            extra_keys=missing,
        )
    return KmerIndex.from_counter_keys(keys)


def is_pickle_file(path) -> bool:
    """Cheap sniff: pickle protocol-2+ files start with b'\\x80'."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
        return len(head) == 2 and head[0] == 0x80
    except OSError:
        return False
