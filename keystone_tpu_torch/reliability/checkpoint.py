"""Checkpoint / restore of fitted pipeline state.

Port of ``keystone_tpu/reliability/checkpoint.py``. The reference got
resumability from Spark lineage: a killed job re-ran, and
already-materialized RDD blocks short-circuited recomputation. Here the
equivalent unit is the ``PipelineEnv`` prefix table — fitted estimator
outputs keyed by the structural prefix of everything that produced them.
This module persists those fitted transformers to disk so a killed run,
restarted in a FRESH process, resumes past already-fit prefixes instead
of refitting them.

The in-memory table keys on :class:`~keystone_tpu_torch.workflow.prefix.Prefix`,
whose operators hash by object identity — useless across processes. The
on-disk key is a *stable digest* of the same tree: operator class
identity plus content-hashed state (tensor and array bytes, dataset
payloads, scalar config). Two structurally identical pipelines built in
different processes over equal data produce equal digests; any attribute
change (different reg, different training data) changes the digest and
forces a refit. The port's digests are not the JAX package's (the class
modules differ); they are equal across two port processes.

Tensors are tokened by their host bytes, so a tensor's token equals its
numpy twin's and does not depend on the device it lies on (bfloat16,
which numpy lacks, is read as int16). An attribute holding an object
(a fitted mapper, a random projection) is tokened by that object's own
attributes, recursively, so a tensor inside it reaches the tensor token.
Attributes named ``device`` and ``torch.device`` values do NOT enter the
digest: where a fit ran is not what it computed, and the store restores
every value onto its own device.

Values are written with ``torch.save`` (the contract of
``FittedPipeline.save``; its legacy format, see :meth:`CheckpointStore.save`)
and read back with
``torch.load(map_location=<the store's device>, weights_only=False)``:
load only stores this program wrote. Writes are atomic (tmp + rename),
so a kill mid-checkpoint never leaves a truncated entry; a torn or
unreadable entry is a miss and is refit, and a ``*.tmp`` file a killed
writer left behind is never read.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import tempfile
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs import names as _names
from .recovery import get_recovery_log

_MISS = object()


def _store_counters():
    return (
        _names.metric(_names.CHECKPOINT_HITS),
        _names.metric(_names.CHECKPOINT_MISSES),
        _names.metric(_names.CHECKPOINT_WRITES),
    )


# ------------------------------------------------------------ stable digests

_token_memo_local = threading.local()
_token_walk_local = threading.local()


@contextlib.contextmanager
def token_memo():
    """Memoize expensive :func:`_value_token` results by object identity
    for the duration of one multi-node digest pass (each dataset is then
    hashed once per plan, not once per node prefix). The memo holds a
    strong reference to every memoized value, which pins its ``id``; it
    dies with the scope. Nested scopes reuse the outermost memo."""
    fresh = getattr(_token_memo_local, "memo", None) is None
    if fresh:
        _token_memo_local.memo = {}
    try:
        yield
    finally:
        if fresh:
            _token_memo_local.memo = None


def _host_array(value: Any):
    """``(dtype name, host array)`` of a tensor or array-like: a tensor is
    copied to the host once (a CUDA tensor included), bfloat16 viewed as
    int16 under its own name."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).cpu().numpy()
        arr = t.cpu().numpy()
        return str(arr.dtype), arr
    arr = np.ascontiguousarray(np.asarray(value))
    return str(arr.dtype), arr


def _value_token(value: Any) -> Any:
    """Deterministic, process-independent token for an operator attribute."""
    if value is None or isinstance(value, (bool, int, str)):
        return ("s", repr(value))
    if isinstance(value, float):
        return ("f", value.hex())
    if isinstance(value, torch.device):
        return ("device",)
    memo = getattr(_token_memo_local, "memo", None)
    if memo is not None:
        hit = memo.get(id(value))
        if hit is not None and hit[0] is value:
            return hit[1]
        token = _value_token_uncached(value)
        memo[id(value)] = (value, token)
        return token
    return _value_token_uncached(value)


def _value_token_uncached(value: Any) -> Any:
    if isinstance(value, bytes):
        return ("b", hashlib.sha1(value).hexdigest())
    if isinstance(value, (list, tuple)):
        return ("t", tuple(_value_token(v) for v in value))
    if isinstance(value, (set, frozenset)):
        # Sorted: set order follows the per-process hash seed.
        return ("set", tuple(sorted(repr(_value_token(v)) for v in value)))
    if isinstance(value, dict):
        return ("d", tuple(sorted((repr(k), _value_token(v)) for k, v in value.items())))
    if isinstance(value, (torch.Tensor, np.ndarray, np.generic)):
        # Content hash of the host bytes: sha1 reads the buffer directly.
        dtype, arr = _host_array(value)
        return ("arr", dtype, tuple(arr.shape), hashlib.sha1(arr).hexdigest())
    if callable(value) and hasattr(value, "__qualname__"):
        return ("fn", getattr(value, "__module__", ""), value.__qualname__)
    # Datasets: payload token + logical length.
    data = getattr(value, "data", None)
    if data is not None and hasattr(value, "num_examples"):
        return ("ds", _value_token(data), int(value.num_examples))
    if hasattr(value, "collect") and hasattr(value, "map"):
        try:
            return ("ods", tuple(_value_token(v) for v in value.collect()))
        except Exception:
            pass
    if hasattr(value, "__dict__") and not isinstance(value, type):
        # An object attribute (a fitted mapper, an estimator): its own
        # attributes, so a tensor inside reaches the tensor token. A
        # cycle back to an object being tokened reads as its type.
        walking = getattr(_token_walk_local, "ids", None)
        if walking is None:
            walking = _token_walk_local.ids = set()
        if id(value) in walking:
            return ("cycle", type(value).__module__, type(value).__qualname__)
        walking.add(id(value))
        try:
            return _op_token(value)
        finally:
            walking.discard(id(value))
    try:
        return ("pkl", hashlib.sha1(pickle.dumps(value)).hexdigest())
    except Exception:
        # Last resort: type identity only — still process-stable.
        return ("type", type(value).__module__, type(value).__qualname__)


def _op_token(op: Any) -> Any:
    """An operator's class identity and its public attributes' tokens
    (``device`` left out: see the module docstring)."""
    attrs = tuple(
        sorted(
            (name, _value_token(v))
            for name, v in vars(op).items()
            if not name.startswith("_") and name != "device"
        )
    )
    return ("op", type(op).__module__, type(op).__qualname__, attrs)


def prefix_digest(prefix: Any) -> str:
    """Stable hex digest of a :class:`Prefix`'s operator tree."""

    def walk(tree):
        op, children = tree
        return (_op_token(op), tuple(walk(c) for c in children))

    token = walk(prefix.tree)
    return hashlib.sha1(repr(token).encode()).hexdigest()


# ------------------------------------------------------------------- store


class CheckpointStore:
    """Directory of ``<digest>.pkl`` fitted-state entries with hit/miss
    accounting, read back onto ``device`` (default CUDA). Lookups
    tolerate torn/unreadable entries (treated as misses); writes are
    atomic."""

    def __init__(self, path: str, device: DeviceLike = None):
        self.path = path
        self.device = resolve_device(device)
        os.makedirs(path, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.writes = 0
        #: bytes of the last successful write (durable-fit commits and
        #: refit state saves report them).
        self.last_write_bytes = 0

    def _entry(self, digest: str) -> str:
        return os.path.join(self.path, f"{digest}.pkl")

    def lookup(self, prefix: Any, digest: Optional[str] = None) -> Any:
        """Stored value for ``prefix``, or the module ``_MISS`` sentinel.
        Pass ``digest`` when already computed — digesting walks the prefix
        tree and content-hashes its datasets, which is not free."""
        hits_c, misses_c, _ = _store_counters()
        entry = self._entry(digest or prefix_digest(prefix))
        if not os.path.exists(entry):
            self.misses += 1
            misses_c.inc()
            return _MISS
        try:
            value = torch.load(entry, map_location=self.device, weights_only=False)
        except Exception:
            self.misses += 1
            misses_c.inc()
            return _MISS
        self.hits += 1
        hits_c.inc()
        return value

    def save(self, prefix: Any, value: Any, digest: Optional[str] = None) -> bool:
        """Persist ``value`` under ``prefix``; returns False (and leaves no
        entry) when the value cannot be serialized — such fits simply
        don't resume."""
        digest = digest or prefix_digest(prefix)
        fd, tmp = tempfile.mkstemp(dir=self.path, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                # The legacy (non-zip) format at protocol 5 writes a numpy
                # payload's buffer as it is: torch.save's default (zip
                # container, protocol 2) re-encodes numpy bytes as latin-1
                # text, 1.5× the bytes, and at protocol 4 the zip writer
                # still took 4× the time (a 128 MiB journal: 0.44 s against
                # 0.11 s on an 8-core x86 host). Tensors keep their storages
                # and map_location in both formats.
                torch.save(value, f, pickle_protocol=5, _use_new_zipfile_serialization=False)
                nbytes = f.tell()
            os.replace(tmp, self._entry(digest))
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self.writes += 1
        self.last_write_bytes = nbytes
        _store_counters()[2].inc()
        return True

    def delete(self, digest: str) -> bool:
        """Remove an entry by digest (the durable-fit layer retires resume
        entries and round journals once their work completed). Missing
        entries are a no-op."""
        try:
            os.unlink(self._entry(digest))
            return True
        except OSError:
            return False

    def get_or_compute(self, prefix: Any, thunk: Callable[[], Any], label: str = "node") -> Any:
        digest = prefix_digest(prefix)  # once per force: lookup + save share it
        value = self.lookup(prefix, digest=digest)
        if value is not _MISS:
            get_recovery_log().record("checkpoint_hit", label, digest=digest[:12])
            return value
        value = thunk()
        if self.save(prefix, value, digest=digest):
            get_recovery_log().record("checkpoint_save", label, digest=digest[:12])
        return value

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "writes": self.writes}


def enable_checkpointing(path: str, env: Optional[Any] = None, device: DeviceLike = None) -> CheckpointStore:
    """Attach a :class:`CheckpointStore` at ``path`` (restoring onto
    ``device``, default CUDA) to the process ``PipelineEnv`` (or a given
    env). Subsequent estimator fits write through; fits whose prefix
    digest is already on disk are restored without refitting."""
    from ..workflow.executor import PipelineEnv

    env = env or PipelineEnv.get_or_create()
    store = CheckpointStore(path, device=device)
    env.checkpoint = store
    return store


__all__ = [
    "CheckpointStore",
    "enable_checkpointing",
    "prefix_digest",
    "token_memo",
]
