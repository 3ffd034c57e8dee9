"""Durable fits: the mid-stream resume contract.

Port of ``keystone_tpu/reliability/durable.py`` on one device. Completed
prefixes restore from the
:class:`~keystone_tpu_torch.reliability.checkpoint.CheckpointStore`, and
the refit state contract (``refit/state.py``) persists sufficient
statistics *between* folds. This module covers the inside of one long
``fit_stream``: a SIGKILL at chunk 4,000 of 5,000 no longer discards
every chunk already folded.

- :class:`StreamCursor` — WHERE a streamed fit was: absolute chunk
  index, rows consumed, the chunk geometry, and the identity
  fingerprints (dataset/labels content digests, featurize-chain digest,
  featurized width/dtype) that make resuming safe.
- :class:`ResumeEntry` — cursor + the
  :class:`~keystone_tpu_torch.refit.state.StreamState` snapshot (host
  numpy carry), persisted in the store under :func:`resume_key`.
- :func:`resume_key` is deliberately COARSER than the cursor's
  fingerprints: it names the logical fit (estimator × chain class × row
  count) so a fresh process re-planning the same pipeline *finds* the
  entry — and ``verify_stream_resume`` (KV306) then refuses it when any
  content fingerprint disagrees. Stale resume is a loud refusal, never
  silent corruption.

The contract is solver-agnostic: envelopes carry an opaque host-numpy
carry (whatever ``kind`` the estimator accumulates), so the sketch tier
is durable too.

- :class:`ShardLossError` — the mid-stream signal that a shard left the
  mesh (raised at the ``parallel.shard_loss`` probe site, once per
  sharded chunk dispatch); the streaming engine catches it, salvages
  the surviving shards' partials and re-plans on the shrunken mesh
  (``workflow/streaming.py``). :func:`shard_loss_index` says which shard
  a simulated loss removes.

Under a sharded plan a commit holds the per-shard partials already
merged (rows summed, feature blocks reassembled), so a cursor resumes on
any mesh; it records the plan's ``mesh_shape``, ``shards`` and
``model_shards``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..envknobs import env_int
from ..refit.state import FORMAT_VERSION, StreamState
from ..utils.tree import tree_leaves
from .checkpoint import _MISS
from .recovery import get_recovery_log

#: Resume-entry layout version — loads refuse unknown versions (a miss,
#: never a mis-resume).
RESUME_FORMAT_VERSION = 1


class ShardLossError(RuntimeError):
    """A shard left the mesh mid-stream. Raised at the
    ``parallel.shard_loss`` probe site (one call per sharded chunk
    dispatch) and caught by ``ChunkStream.fold``, which salvages the
    surviving shards' partials and continues on the shrunken mesh."""

    def __init__(self, lost_shard: int, chunk_index: int, shards: int):
        self.lost_shard = int(lost_shard)
        self.chunk_index = int(chunk_index)
        self.shards = int(shards)
        super().__init__(f"shard {lost_shard}/{shards} lost at chunk {chunk_index}")


# ----------------------------------------------------------------- knobs


def stream_ckpt_chunks(n_rows: int) -> int:
    """Chunks between mid-fit checkpoint commits; 0 = off.

    ``KEYSTONE_STREAM_CKPT_CHUNKS`` set explicitly wins (0 disables even
    for huge fits). Unset, checkpointing auto-arms at every
    ``KEYSTONE_STREAM_CKPT_AUTO_EVERY`` (default 32) chunks once the
    dataset holds at least ``KEYSTONE_STREAM_CKPT_AUTO_ROWS`` rows
    (default 1e6) — small fits are cheaper to redo than to checkpoint.
    """
    explicit = env_int("KEYSTONE_STREAM_CKPT_CHUNKS", -1)
    if explicit >= 0:
        return explicit
    if n_rows >= env_int("KEYSTONE_STREAM_CKPT_AUTO_ROWS", 1_000_000):
        return max(1, env_int("KEYSTONE_STREAM_CKPT_AUTO_EVERY", 32))
    return 0


def shard_loss_index(shards: int) -> int:
    """Which shard a *simulated* loss removes (default: the last).
    ``KEYSTONE_SHARD_LOSS_INDEX`` overrides it, so that a test reaches the
    seed-bearing shard 0. A real loss would carry the failed device's
    identity instead."""
    idx = env_int("KEYSTONE_SHARD_LOSS_INDEX", shards - 1)
    return min(max(idx, 0), shards - 1)


# ------------------------------------------------------------- identity


def content_digest(value: Any) -> str:
    """Process-stable content digest of a dataset/operator attribute —
    the checkpoint layer's ``_value_token`` hashed, so the rules stay in
    one place."""
    from .checkpoint import _value_token

    return hashlib.sha1(repr(_value_token(value)).encode()).hexdigest()


#: Above this, tensor/array leaves fingerprint by shape/dtype + a
#: deterministic strided row sample instead of a full-content pass.
FULL_HASH_MAX_BYTES = 64 << 20
#: Rows sampled (first + last always included) for oversized leaves.
FINGERPRINT_SAMPLE_ROWS = 257


def _leaf_nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def dataset_fingerprint(ds: Any) -> str:
    """Process-stable fingerprint of a dataset for resume validation.

    Small payloads hash in full; tensor and array leaves past
    :data:`FULL_HASH_MAX_BYTES` hash their shape/dtype plus an
    evenly-strided sample of :data:`FINGERPRINT_SAMPLE_ROWS` rows. The
    sample is gathered where the leaf lies — on the card for a CUDA
    dataset — and only those rows are copied to the host: a multi-GB
    card dataset is never copied at plan time. The trade: a drift
    confined to unsampled rows is missed (KV306 is a stale-RESUME guard,
    not a data-integrity audit). A tensor and its numpy twin fingerprint
    alike."""
    from .checkpoint import _host_array

    data = getattr(ds, "data", None)
    n = getattr(ds, "num_examples", None)
    if data is None or n is None:
        return content_digest(ds)
    h = hashlib.sha1(f"ds:n{int(n)}".encode())
    for leaf in tree_leaves(data):
        if not isinstance(leaf, (np.ndarray, torch.Tensor)):
            h.update(content_digest(leaf).encode())
            continue
        dtype = _host_array(leaf.reshape(-1)[:0])[0]
        h.update(f"{dtype}{tuple(leaf.shape)}".encode())
        if _leaf_nbytes(leaf) <= FULL_HASH_MAX_BYTES or leaf.ndim == 0:
            h.update(_host_array(leaf)[1])
        else:
            rows = np.unique(
                np.linspace(0, leaf.shape[0] - 1, FINGERPRINT_SAMPLE_ROWS).astype(np.int64)
            )
            h.update(rows.tobytes())
            if isinstance(leaf, torch.Tensor):
                sample = leaf[torch.from_numpy(rows).to(leaf.device)]
            else:
                sample = leaf[rows]
            h.update(_host_array(sample)[1])
    return h.hexdigest()


def chain_digest(members: Tuple[Any, ...]) -> str:
    """Content digest of the featurize chain BETWEEN the data source and
    the estimator — class identity plus content-hashed state (weights
    included: a chain with different weights produces different
    features, so resuming across it would corrupt the fit)."""
    from .checkpoint import _op_token

    return hashlib.sha1(repr([_op_token(m) for m in members]).encode()).hexdigest()


def resume_key(estimator: Any, members: Tuple[Any, ...], n_rows: int) -> str:
    """Checkpoint-store digest naming the LOGICAL fit: same estimator
    class, same chain op sequence, same row count → same key, so a
    re-planned pipeline finds the entry and KV306 gets to rule on
    whether the contents still agree."""
    from ..workflow.streaming import chain_class

    est = f"{type(estimator).__module__}.{type(estimator).__qualname__}"
    token = f"keystone-stream-resume:{est}:{chain_class(members)}:n{n_rows}"
    return hashlib.sha1(token.encode()).hexdigest()


# -------------------------------------------------------------- envelope


@dataclass
class StreamCursor:
    """Where a streamed fit stood when its state was committed."""

    chunk_index: int          # absolute chunks fully folded
    rows_consumed: int        # logical dataset rows those chunks held
    chunk_rows: int           # chunk geometry (must match to resume)
    dataset_digest: str
    labels_digest: str
    chain_digest: str
    feature_width: int
    feature_dtype: str
    mesh_shape: Tuple[int, ...] = ()
    shards: int = 1
    model_shards: int = 1


@dataclass
class ResumeEntry:
    """One persisted mid-fit snapshot: cursor + state."""

    cursor: StreamCursor
    state: StreamState
    #: rows the fold's SEED state held that did not come from this
    #: dataset (a refit-seeded fold), kept apart from ``rows_consumed``
    #: so totals stay exact.
    seed_rows: int = 0
    format_version: int = RESUME_FORMAT_VERSION


def save_resume_entry(store: Any, key: str, entry: ResumeEntry) -> bool:
    return store.save(None, entry, digest=key)


def load_resume_entry(store: Any, key: str) -> Optional[ResumeEntry]:
    """The persisted entry, or None (missing/torn/foreign versions are
    misses — the checkpoint-store contract)."""
    value = store.lookup(None, digest=key)
    if value is _MISS or not isinstance(value, ResumeEntry):
        return None
    if value.format_version != RESUME_FORMAT_VERSION:
        return None
    if value.state.format_version != FORMAT_VERSION:
        return None
    return value


def clear_resume_entry(store: Any, key: str) -> None:
    store.delete(key)


# --------------------------------------------------------- fold-side plan


@dataclass
class DurableFold:
    """The durability plan ``ChunkStream.fold`` executes (built by the
    streaming operator's arm step; ``None`` on a stream = the fold
    without checkpoints)."""

    store: Any                      # reliability CheckpointStore
    key: str                        # resume-entry digest
    kind: str                       # stream-state kind ("gram", ...)
    estimator: str                  # estimator qualname for the envelope
    ckpt_every: int                 # chunks between commits (0 = never)
    #: Extra envelope meta the committed StreamState must carry (the
    #: sketch tier's {sketch_variant, sketch_seed}).
    state_meta: Dict[str, Any] = field(default_factory=dict)
    fingerprints: Dict[str, Any] = field(default_factory=dict)
    start_chunk: int = 0            # chunks to skip (resumed fold)
    resume_rows: int = 0            # rows those skipped chunks held
    seed_rows: int = 0              # non-dataset rows in the seed state

    def cursor(
        self,
        chunk_index: int,
        rows_consumed: int,
        chunk_rows: int,
        mesh_shape: Tuple[int, ...] = (),
        shards: int = 1,
        model_shards: int = 1,
    ) -> StreamCursor:
        return StreamCursor(
            chunk_index=chunk_index,
            rows_consumed=rows_consumed,
            chunk_rows=chunk_rows,
            mesh_shape=tuple(mesh_shape),
            shards=int(shards),
            model_shards=int(model_shards),
            **self.fingerprints,
        )

    def commit(
        self,
        host_carry: Tuple[np.ndarray, ...],
        chunk_index: int,
        rows_consumed: int,
        chunk_rows: int,
        mesh_shape: Tuple[int, ...] = (),
        shards: int = 1,
        model_shards: int = 1,
    ) -> bool:
        """Persist one mid-fit snapshot (atomic tmp+rename underneath).
        Called by the fold with the carry ALREADY copied to the host and,
        under a sharded plan, merged over the shards — the
        commit-before-continue barrier is the fold's job; this is the
        write. Best-effort: a failed write is ledgered and the fit
        continues (durability never fails a fit that would succeed)."""
        state = StreamState(
            kind=self.kind,
            estimator=self.estimator,
            num_examples=int(self.seed_rows + rows_consumed),
            carry=tuple(np.asarray(a) for a in host_carry),
            meta={**self.state_meta, "durable": True},
        )
        entry = ResumeEntry(
            cursor=self.cursor(chunk_index, rows_consumed, chunk_rows, mesh_shape, shards, model_shards),
            state=state,
            seed_rows=self.seed_rows,
        )
        ok = save_resume_entry(self.store, self.key, entry)
        if ok:
            from ..obs import names as _names

            _names.metric(_names.DURABLE_CHECKPOINTS).inc()
            get_recovery_log().record(
                "stream_checkpoint",
                self.estimator,
                chunk_index=chunk_index,
                rows_consumed=rows_consumed,
                key=self.key[:12],
            )
        else:
            get_recovery_log().record(
                "stream_checkpoint_failed",
                self.estimator,
                chunk_index=chunk_index,
                key=self.key[:12],
            )
        return ok

    def complete(self) -> None:
        """The fit finished: a resume entry pointing into its middle must
        not outlive it."""
        clear_resume_entry(self.store, self.key)


# -------------------------------------------------------------------- arming


def arm_durable_fold(stream: Any, estimator: Any, store: Any, ckpt_every: Optional[int] = None):
    """Build a stream's durability plan and, when a valid resume entry
    exists, the :class:`StreamState` that seeds the fold.

    Returns ``(durable, resume_state)`` — ``(None, None)`` when
    durability stays off (checkpointing off for this size and no entry
    to resume). ``ckpt_every`` overrides the size-based
    :func:`stream_ckpt_chunks` cadence.

    Refusal ladder for an existing entry:

    - geometry drift (a ``chunk_rows`` that no longer matches the
      cursor's) — the entry is *discarded* with a ``resume_discard``
      ledger event: chunk boundaries can't realign, nothing is corrupt;
    - fingerprint drift (dataset/labels/chain content, featurized
      width/dtype) — the entry is *refused* via ``verify_stream_resume``
      (KV306): warn mode re-ingests from scratch,
      ``KEYSTONE_VERIFY=strict`` raises
      :class:`~keystone_tpu_torch.workflow.verify.VerificationError`.
    """
    from ..obs import names as _names
    from ..workflow.verify import VerificationError, verification_mode, verify_stream_resume

    members = stream.members
    n = stream.num_examples
    every = ckpt_every if ckpt_every is not None else stream_ckpt_chunks(n)
    key = resume_key(estimator, members, n)
    entry = load_resume_entry(store, key)
    if every <= 0 and entry is None:
        return None, None

    leaves = tree_leaves(stream.feature_aval())
    if len(leaves) == 1 and len(leaves[0].shape) == 2:
        width, dtype = int(leaves[0].shape[1]), str(leaves[0].dtype)
    else:
        width, dtype = -1, "|".join(str(leaf.dtype) for leaf in leaves)
    fingerprints = {
        "dataset_digest": dataset_fingerprint(stream.data),
        "labels_digest": dataset_fingerprint(stream.labels),
        "chain_digest": chain_digest(members),
        "feature_width": width,
        "feature_dtype": dtype,
    }
    # Meta-estimators pick their rung per stream, so the committed
    # state's kind/meta come from the CHOSEN rung.
    kind_for = getattr(estimator, "stream_state_kind_for", None)
    kind = kind_for(stream) if callable(kind_for) else getattr(estimator, "stream_state_kind", "gram")
    meta_for = getattr(estimator, "stream_state_meta_for", None)
    if callable(meta_for):
        state_meta = dict(meta_for(stream) or {})
    else:
        state_meta = dict(getattr(estimator, "stream_state_meta", {}) or {})
    durable = DurableFold(
        store=store,
        key=key,
        kind=kind,
        estimator=f"{type(estimator).__module__}.{type(estimator).__qualname__}",
        ckpt_every=every,
        state_meta=state_meta,
        fingerprints=fingerprints,
    )
    if entry is None:
        return durable, None

    if entry.cursor.chunk_rows != stream.chunk_rows:
        get_recovery_log().record(
            "resume_discard",
            durable.estimator,
            reason="chunk-geometry-drift",
            entry_chunk_rows=entry.cursor.chunk_rows,
            planned_chunk_rows=stream.chunk_rows,
        )
        _names.metric(_names.DURABLE_RESUME_REFUSED).inc(reason="geometry")
        clear_resume_entry(store, key)
        return durable, None

    report = verify_stream_resume(entry.cursor, fingerprints)
    if not report.ok:
        get_recovery_log().record(
            "resume_refused",
            durable.estimator,
            codes=sorted({d.code for d in report.errors()}),
            fields=sorted({str(d.details.get("field")) for d in report.errors()}),
        )
        _names.metric(_names.DURABLE_RESUME_REFUSED).inc(reason="kv306")
        if verification_mode() == "strict":
            # Strict refuses the FIT, not the entry: the mismatch may be
            # THIS run's mistake, and deleting here would destroy the
            # legitimate job's checkpoint work.
            raise VerificationError(report)
        clear_resume_entry(store, key)
        return durable, None

    durable.start_chunk = int(entry.cursor.chunk_index)
    durable.resume_rows = int(entry.cursor.rows_consumed)
    durable.seed_rows = int(entry.seed_rows)
    _names.metric(_names.DURABLE_RESUMES).inc(kind="crash")
    get_recovery_log().record(
        "stream_resume",
        durable.estimator,
        chunk_index=entry.cursor.chunk_index,
        rows_consumed=entry.cursor.rows_consumed,
        key=key[:12],
    )
    return durable, entry.state


__all__ = [
    "DurableFold",
    "ResumeEntry",
    "StreamCursor",
    "arm_durable_fold",
    "chain_digest",
    "clear_resume_entry",
    "content_digest",
    "dataset_fingerprint",
    "load_resume_entry",
    "resume_key",
    "save_resume_entry",
    "stream_ckpt_chunks",
]
