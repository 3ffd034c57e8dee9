"""Block least-squares solvers (feature-block coordinate descent).

Port of ``keystone_tpu/ops/learning/block.py``: ``BlockLinearMapper`` and
``BlockLeastSquaresEstimator.fit`` with the same three-way dispatch —

- ``sparse``: sparse CSR rows (or a host matrix) whose block density is
  at or below the threshold fit from block-sparse sufficient statistics
  (``ops/cuda/blocksparse.py``, the CUDA ELL kernel), finished by
  ``linalg.gram_stream_finish`` + ``linalg.bcd_from_gram``;
- ``densify``: CSR rows that are too dense (or ``KEYSTONE_BLOCKSPARSE=off``)
  are densified once on the device and take the dense path;
- dense: the in-core block coordinate descent, or, for a host matrix too
  large for the card, host streaming (``linalg.block_coordinate_descent_streaming``:
  one feature block uploaded per update).

Host streaming (``host_streaming=None``, the default, decides it): the fit
streams when its device is a card and the features are a CPU tensor
larger than ``KEYSTONE_STREAM_BYTES`` (default 4e9 bytes). ``ArrayDataset``
uploads a numpy array when it is built, so a host matrix is an
``ArrayDataset`` of a CPU tensor or one built with ``device="cpu"``.
``True`` / ``False`` force the choice.

``fit_stream`` is the chunked fit of the streaming engine
(``workflow/streaming.py``): it accumulates the same sufficient
statistics chunk by chunk, and the streamed fit and the block-sparse fit
share one finish, :meth:`BlockLeastSquaresEstimator._finish_from_stats`.

Reliability and observability, as in the JAX package:

- an OOM degradation ladder (``DegradationLadder(halving_rungs(block0,
  block0 // 4))``) around the sparse, in-core and host-streamed fits: an
  out-of-memory error at one block size (``torch.cuda.OutOfMemoryError``
  from the allocator or the solver binding, or an injected OOM) retries
  at half the block, two halvings at most, and a model fitted at a
  smaller block carries ``model.degradation``; any other error is
  re-raised;
- ``probe("BlockLeastSquaresEstimator.solve")`` at the head of each fit
  attempt and of ``fit_stream``, the fault-injection site;
- ``solver:fit`` and ``solver:iteration`` spans with the solver
  histogram and rung counter (``obs/solver.py``);
- one ``solver:<solver>:bs<block>:prec<mode>`` observation per fit in the
  profile store (``obs/store.py``), and the dispatch threshold read from
  it per rows bucket.

The refit state contract (``refit/state.py``, ``GramStreamStateMixin``):
``fit_stream(stream, state=None)`` seeds its carry from a captured
``StreamState`` and captures the extended one, and ``finish_from_state``
runs the same finish from statistics alone.

Meshes (``parallel/mesh.py``): a fit shards over ``partitioner.fit_mesh``
— the partition batch's pinned mesh, else the ambient one (one shard by
default, which is the single-device path). With several row shards the
in-core fit runs ``linalg.block_coordinate_descent`` over them; on a
(``data``, ``model``) mesh ``linalg.block_coordinate_descent_2d`` (the
feature dimension padded to model shards × block); host streaming runs
over the row shards too, and is chosen automatically only on meshes
without a ``model`` axis. The block-sparse fit stays single-device, as in
the JAX package. The streamed fit's sharded chunk plan lives in the
engine (``workflow/streaming.py``).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset, ObjectDataset
from ...device import DeviceLike, resolve_device
from ...envknobs import env_disabled, env_int
from ...obs import names as _names
from ...obs import solver as solver_obs
from ...obs import store as obs_store
from ...parallel import linalg
from ...parallel.partitioner import fit_mesh
from ...refit.state import GramStreamStateMixin
from ...reliability import DegradationLadder, halving_rungs, probe
from ...utils.sparse import BlockSparseMatrix, block_density_exceeds, is_sparse_rows
from ...workflow.pipeline import BatchTransformer, LabelEstimator
from ..cuda import blocksparse as _bs


class BlockLinearMapper(BatchTransformer):
    """Apply a block-solved linear model: (x − μ_A)·W + b, on the device
    the weights live on."""

    def __init__(
        self,
        weights: torch.Tensor,  # (d_padded, k)
        block_size: int,
        intercept: Optional[torch.Tensor] = None,
        feature_mean: Optional[torch.Tensor] = None,  # (d,)
    ):
        self.weights = weights
        self.block_size = block_size
        self.intercept = intercept
        self.feature_mean = feature_mean

    def apply_arrays(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.weights.device)
        d = x.shape[-1]
        if self.feature_mean is not None:
            x = x - self.feature_mean
        out = linalg.mm(x, self.weights[:d])  # drop padded feature rows
        if self.intercept is not None:
            out = out + self.intercept
        return out


def _as_array_dataset(data: Dataset, device: torch.device) -> ArrayDataset:
    if isinstance(data, ArrayDataset):
        return data
    if isinstance(data, BucketedDataset):
        return data.concat()
    return data.to_arrays(device=device)  # type: ignore[attr-defined]


class BlockLeastSquaresEstimator(GramStreamStateMixin, LabelEstimator):
    """Feature-block coordinate-descent least squares: ``num_iter`` full
    epochs over the feature blocks, λ applied per block. Fits on
    ``device`` (default CUDA). ``host_streaming``: None decides by the
    rule in the module docstring; True or False force it."""

    #: Chunked-fit protocol (workflow/streaming.py): this estimator can
    #: consume featurized row chunks incrementally via Gram accumulation.
    supports_fit_stream = True

    #: 2-D partitioner protocol: the Gram carry blocks its feature rows
    #: (``gram_stream_step.model_block_step``) on a (data, model) mesh.
    supports_model_axis = True

    def __init__(
        self,
        block_size: int,
        num_iter: int = 1,
        reg: float = 0.0,
        device: DeviceLike = None,
        host_streaming: Optional[bool] = None,
    ):
        self.block_size = block_size
        self.num_iter = num_iter
        self.reg = reg
        self.device = device
        self.host_streaming = host_streaming

    @property
    def weight(self) -> int:
        """Passes over its input (the reference's WeightedOperator): the
        auto-cache planner multiplies a node's recomputations by it."""
        return 3 * self.num_iter + 1

    def out_spec(self, in_specs):
        """Plan-time spec protocol (``workflow/verify.py``): the fitted
        map takes (m, d) to (m, k)."""
        from ...workflow.verify import dense_fit_spec

        return dense_fit_spec(in_specs, self.label)

    def fit_stream(self, stream, state=None) -> BlockLinearMapper:
        """Row-chunked fit: accumulate (AᵀA, AᵀY, Σx, Σy) one chunk at a
        time on the stream's device, then run the SAME Gauss-Seidel block
        updates as the in-core solver from the centered statistics —
        O(d²) residency instead of O(n·d); the feature matrix never
        exists. ``state`` (a refit ``StreamState``) seeds the carry from
        an earlier fit's statistics; the extended state is captured for
        ``export_stream_state``."""
        probe("BlockLeastSquaresEstimator.solve")

        def init(feat_spec, y_spec):
            d, k = _stream_shapes(feat_spec, y_spec)
            return self._seed_carry(state, d, k, stream.device)

        t_fit = time.perf_counter()
        with solver_obs.fit_span(
            "block_ls_stream", epochs=self.num_iter, **solver_obs.predicted_attrs(self)
        ):
            carry, info = stream.fold(init, linalg.gram_stream_step)
            n = info["num_examples"] + (state.num_examples if state else 0)
            self._capture_state(
                carry, n, reg=self.reg, block_size=self.block_size, num_iter=self.num_iter,
            )
            mapper = self._finish_from_stats(carry, n)
        _record_solver_observation(
            "block_ls_stream", rows=n, d=int(carry[0].shape[0]),
            block_size=mapper.block_size, wall_s=time.perf_counter() - t_fit,
            rungs_attempted=1,
        )
        return mapper

    def _finish_from_stats(self, carry, n: int, block: Optional[int] = None) -> BlockLinearMapper:
        """Gauss-Seidel block solve from accumulated statistics alone —
        shared by the streamed and the block-sparse fits and
        ``finish_from_state`` (no data pass,
        O(d²) inputs). ``block`` is the ladder's rung (default
        ``block_size``)."""
        gc, cc, mu_a, mu_b = linalg.gram_stream_finish(carry, n)
        d = gc.shape[0]
        block = min(block or self.block_size, d)
        # The in-core fit's λ floor: 1e-6 of the mean Gram diagonal —
        # trace(Gc)/(n·d) is E[x²] of the centered data.
        reg = self.reg if self.reg > 0 else max(1e-6 * float(torch.trace(gc)) / d, 1e-6)
        d_pad = _round_up(d, block)
        if d_pad != d:  # zero pad rows/cols are inert (λ keeps PD)
            gc = torch.nn.functional.pad(gc, (0, d_pad - d, 0, d_pad - d))
            cc = torch.nn.functional.pad(cc, (0, 0, 0, d_pad - d))
        w = linalg.bcd_from_gram(gc, cc, reg=reg, num_epochs=self.num_iter, block_size=block)
        return BlockLinearMapper(w, block_size=block, intercept=mu_b, feature_mean=mu_a)

    def fit(self, data: Dataset, labels: Dataset) -> BlockLinearMapper:
        device = resolve_device(self.device)
        dispatch = self._blocksparse_dispatch(data)
        if dispatch is not None:
            kind, bsr, a_dense, threshold = dispatch
            if kind == "sparse":
                targets = _as_array_dataset(labels, device)
                # The dense paths' OOM contract: a smaller block shrinks
                # bcd_from_gram's per-block factor and workspace, two
                # halvings before giving up.
                block0 = min(self.block_size, bsr.shape[1])
                ladder = DegradationLadder(
                    halving_rungs(block0, max(block0 // 4, 1)),
                    label="BlockLeastSquaresEstimator.fit",
                )
                attempts = iter(range(len(ladder.rungs)))

                def sparse_attempt(block):
                    with solver_obs.rung_span("block_ls_sparse", block, next(attempts)):
                        return self._fit_blocksparse(
                            bsr, targets, threshold, a_dense=a_dense, block=block
                        )

                model = ladder.run(sparse_attempt)
                if ladder.reduced:
                    model.degradation = dict(ladder.record)
                return model
            # CSR rows that are too dense (or dispatch disabled): densify
            # once through BSR — the only way this estimator consumes them.
            m, d = bsr.shape
            data = ArrayDataset(_bs.bsr_to_dense(bsr, device)[:m, :d])
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        raw = features.data
        d = raw.shape[1]
        mesh = fit_mesh(self)
        stream = self.host_streaming
        if stream is None:
            # Only on meshes without a model axis: the streaming solver
            # shards rows only, and the 2-D in-core path owns that layout.
            stream = _auto_host_streaming(raw, device) and linalg.model_axis_size(mesh) == 1
        block0 = min(self.block_size, d)
        # OOM degradation: a smaller block shrinks the live Gram workspace
        # and (streaming) the per-block panel on the card; two halvings
        # cover the realistic headroom gap before the problem itself is
        # too big.
        ladder = DegradationLadder(
            halving_rungs(block0, max(block0 // 4, 1)),
            label="BlockLeastSquaresEstimator.fit",
        )
        fit_impl = self._fit_streaming if stream else self._fit_in_core
        attempts = iter(range(len(ladder.rungs)))

        def attempt(block):
            with solver_obs.rung_span("block_ls", block, next(attempts)):
                return fit_impl(features, targets, block, device, mesh)

        t_fit = time.perf_counter()
        with solver_obs.fit_span(
            "block_ls", d=d, epochs=self.num_iter, streaming=bool(stream),
            **solver_obs.predicted_attrs(self),
        ):
            model = ladder.run(attempt)
        if ladder.reduced:
            model.degradation = dict(ladder.record)
        _record_solver_observation(
            "block_ls", rows=features.num_examples, d=d, block_size=model.block_size,
            wall_s=time.perf_counter() - t_fit,
            rungs_attempted=1 + int(ladder.record.get("rung_index", 0)),
        )
        return model

    def _fit_streaming(
        self, features: ArrayDataset, targets: ArrayDataset, block: int,
        device: torch.device, mesh=None,
    ) -> BlockLinearMapper:
        """One feature block of the host matrix uploaded per update
        (``linalg.block_coordinate_descent_streaming``)."""
        probe("BlockLeastSquaresEstimator.solve")
        raw = features.data.cpu()
        n = features.num_examples
        reg = self.reg if self.reg > 0 else _scale_aware_reg_floor(raw[: min(n, 4096)], n)
        w, mu_a, mu_b = linalg.block_coordinate_descent_streaming(
            raw, targets.data, reg=reg, num_epochs=self.num_iter, block_size=block,
            num_examples=n, device=device, mesh=mesh,
        )
        return BlockLinearMapper(w.to(device), block_size=block, intercept=mu_b, feature_mean=mu_a)

    def _fit_in_core(
        self, features: ArrayDataset, targets: ArrayDataset, block: int,
        device: torch.device, mesh=None,
    ) -> BlockLinearMapper:
        probe("BlockLeastSquaresEstimator.solve")
        x = features.data.to(device=device, dtype=torch.float32)
        y = targets.data.to(device=device, dtype=torch.float32)
        n = features.num_examples
        d = x.shape[1]
        mask = features.mask().to(device).reshape(-1, 1)

        mu_a = (x * mask).sum(dim=0) / n
        mu_b = (y * mask).sum(dim=0) / n
        xc = (x - mu_a) * mask
        yc = (y - mu_b) * mask
        del x

        # The reg floor sees the real rows only, before column padding.
        reg = self.reg if self.reg > 0 else _scale_aware_reg_floor(xc[:n], n)

        # Pad the feature dim to whole blocks (zero columns are inert:
        # their Gram rows/cols are zero and λ keeps the solve PD); on a 2-D
        # mesh each model group needs whole blocks: model shards × block.
        m = linalg.model_axis_size(mesh) if mesh is not None else 1
        d_pad = _round_up(d, block * m)
        if d_pad != d:
            xc = torch.nn.functional.pad(xc, (0, d_pad - d))
        if m > 1:
            w = linalg.block_coordinate_descent_2d(
                xc, yc, reg=reg, num_epochs=self.num_iter, block_size=block, mesh=mesh
            )
        else:
            w = linalg.block_coordinate_descent(
                xc, yc, reg=reg, num_epochs=self.num_iter, block_size=block, mesh=mesh
            )
        return BlockLinearMapper(w.to(device), block_size=block, intercept=mu_b, feature_mean=mu_a)

    # ------------------------------------------------------- block-sparse
    def _blocksparse_dispatch(self, data):
        """``(kind, bsr, a_dense, threshold)`` or None for the dense path
        untouched. ``kind`` is ``"sparse"`` (fit on the BSR kernel) or
        ``"densify"`` (CSR rows that must be densified regardless,
        including under ``KEYSTONE_BLOCKSPARSE=off``). Only host data is
        probed: CSR rows, or a CPU-tensor ArrayDataset no larger than
        :func:`_blocksparse_probe_bytes` (the JAX package probes host
        numpy matrices only; device arrays go dense)."""
        disabled = env_disabled("KEYSTONE_BLOCKSPARSE")
        if isinstance(data, ObjectDataset):
            items = data.collect()
            if not is_sparse_rows(items):
                return None
            d = int(items[0].shape[-1])
            bsr = BlockSparseMatrix.from_csr_rows(items, _bs.default_block_shape(d))
            threshold = _bs.density_threshold(
                obs_store.rows_bucket(obs_store.shape_class(bsr.shape[0]))
            )
            if not disabled and bsr.density() <= threshold:
                return ("sparse", bsr, None, threshold)
            return ("densify", bsr, None, threshold)
        if disabled or not isinstance(data, ArrayDataset):
            return None
        raw = data.data
        if (
            raw.device.type != "cpu"
            or raw.ndim != 2
            or raw.shape[0] != data.num_examples  # padded rows: mask owed
            or raw.numel() * raw.element_size() > _blocksparse_probe_bytes()
        ):
            return None
        host = raw.numpy()
        block_shape = _bs.default_block_shape(host.shape[1])
        threshold = _bs.density_threshold(obs_store.rows_bucket(obs_store.shape_class(host.shape[0])))
        if block_density_exceeds(host, block_shape, threshold):
            return None
        return ("sparse", BlockSparseMatrix.from_dense(host, block_shape), raw, threshold)

    def _fit_blocksparse(
        self,
        bsr: BlockSparseMatrix,
        targets: ArrayDataset,
        threshold: float,
        a_dense: Optional[torch.Tensor] = None,
        block: Optional[int] = None,
    ) -> BlockLinearMapper:
        """Fit from block-sparse sufficient statistics (AᵀA, AᵀY, Σx, Σy),
        then the streamed fit's finish (:meth:`_finish_from_stats`) at
        ``block`` (the ladder's rung). ``impl`` names what multiplied:
        ``cuda`` (the ELL kernel) or ``reference`` (its plain version,
        on CPU tensors)."""
        probe("BlockLeastSquaresEstimator.solve")
        device = resolve_device(self.device)
        impl = "cuda" if device.type == "cuda" else "reference"
        n, d = bsr.shape
        t_fit = time.perf_counter()
        with solver_obs.fit_span(
            "block_ls_sparse", d=d, epochs=self.num_iter,
            density=round(bsr.density(), 4), impl=impl,
        ):
            y = targets.data.to(device=device, dtype=torch.float32)[:n]
            totals = _bs.bsr_gram_totals(bsr, y, a_dense=a_dense)
            model = self._finish_from_stats(totals, n, block)
        _names.metric(_names.BLOCKSPARSE_FITS).inc(impl=impl)
        _names.metric(_names.BLOCKSPARSE_BLOCKS_SKIPPED).inc(bsr.blocks_skipped())
        _record_solver_observation(
            "block_ls_sparse", rows=n, d=d, block_size=model.block_size,
            wall_s=time.perf_counter() - t_fit, rungs_attempted=1,
            density=round(bsr.density(), 6), blocks_skipped=bsr.blocks_skipped(),
            threshold=threshold,
        )
        return model


def _blocksparse_probe_bytes() -> int:
    """Ceiling on the host feature matrix the fast path will tile-probe.
    ``KEYSTONE_BLOCKSPARSE_PROBE_BYTES`` overrides."""
    return env_int("KEYSTONE_BLOCKSPARSE_PROBE_BYTES", int(512e6))


def _record_solver_observation(
    solver: str,
    rows: int,
    d: int,
    block_size: int,
    wall_s: float,
    rungs_attempted: int,
    **extra,
) -> None:
    """Remember what this (block size, precision) pair cost on this shape
    class, under ``solver:<solver>:bs<block>:prec<mode>``. Best effort: a
    disabled or broken store never blocks a fit (``record`` logs and
    swallows its own errors)."""
    store = obs_store.get_store()
    if store is None:
        return
    mode = linalg.solver_mode()
    store.record(
        f"solver:{solver}:bs{block_size}:prec{mode}",
        obs_store.shape_class(rows, (d,), "float32"),
        wall_s=round(wall_s, 6),
        block_size=block_size,
        precision=mode,
        solver_rung=rungs_attempted,
        **extra,
    )


def _auto_host_streaming(raw: torch.Tensor, device: torch.device) -> bool:
    """``host_streaming=None``'s rule: stream a CPU-tensor feature matrix
    larger than :func:`_host_streaming_threshold_bytes` into a fit on a
    card."""
    return (
        device.type == "cuda"
        and raw.device.type == "cpu"
        and raw.numel() * raw.element_size() > _host_streaming_threshold_bytes()
    )


def _host_streaming_threshold_bytes() -> int:
    """Above this many bytes a host feature matrix is streamed block by
    block instead of uploaded whole (the in-core path also holds a
    centered copy, so its residency is about twice the matrix).
    ``KEYSTONE_STREAM_BYTES`` overrides."""
    return env_int("KEYSTONE_STREAM_BYTES", int(4e9))


def _stream_shapes(feat_spec, y_spec):
    """(d, k) from the streaming engine's featurized / label chunk specs;
    rejects chains that do not end in one (rows, d) matrix (the engine
    falls back to the materialized path)."""
    from ...utils.tree import tree_leaves
    from ...workflow.streaming import StreamingFallback

    leaves = tree_leaves(feat_spec)
    if len(leaves) != 1 or len(leaves[0].shape) != 2:
        raise StreamingFallback(
            "gram streaming needs a single (rows, d) feature chunk, got "
            f"{[tuple(leaf.shape) for leaf in leaves]}"
        )
    return leaves[0].shape[1], y_spec.shape[1]


def _scale_aware_reg_floor(x_sample: torch.Tensor, n: int) -> float:
    """λ floor for an unregularized solve: 1e-6 of the mean Gram diagonal
    (≈ 1e-6·n·E[x²] of the centered data), so a rank-deficient block
    keeps a finite fp32 Cholesky factor."""
    xs = x_sample.to(torch.float32)
    xs = xs - xs.mean(dim=0, keepdim=True)
    mean_sq = float(xs.square().mean())
    return max(1e-6 * n * mean_sq, 1e-6)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
