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

Left out (later slices): the OOM degradation ladder, obs spans and
metrics, the profile store, 2-D meshes and the refit state mixin
(``fit_stream`` takes no ``state``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...data.dataset import ArrayDataset, BucketedDataset, Dataset, ObjectDataset
from ...device import DeviceLike, resolve_device
from ...envknobs import env_disabled, env_int
from ...parallel import linalg
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


class BlockLeastSquaresEstimator(LabelEstimator):
    """Feature-block coordinate-descent least squares: ``num_iter`` full
    epochs over the feature blocks, λ applied per block. Fits on
    ``device`` (default CUDA). ``host_streaming``: None decides by the
    rule in the module docstring; True or False force it."""

    #: Chunked-fit protocol (workflow/streaming.py): this estimator can
    #: consume featurized row chunks incrementally via Gram accumulation.
    supports_fit_stream = True

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

    def fit_stream(self, stream) -> BlockLinearMapper:
        """Row-chunked fit: accumulate (AᵀA, AᵀY, Σx, Σy) one chunk at a
        time on the stream's device, then run the SAME Gauss-Seidel block
        updates as the in-core solver from the centered statistics —
        O(d²) residency instead of O(n·d); the feature matrix never
        exists."""

        def init(feat_spec, y_spec):
            d, k = _stream_shapes(feat_spec, y_spec)
            return linalg.gram_stream_init(d, k, stream.device)

        carry, info = stream.fold(init, linalg.gram_stream_step)
        return self._finish_from_stats(carry, info["num_examples"])

    def _finish_from_stats(self, carry, n: int) -> BlockLinearMapper:
        """Gauss-Seidel block solve from accumulated statistics alone —
        shared by the streamed and the block-sparse fits (no data pass,
        O(d²) inputs)."""
        gc, cc, mu_a, mu_b = linalg.gram_stream_finish(carry, n)
        d = gc.shape[0]
        block = min(self.block_size, d)
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
                return self._fit_blocksparse(
                    bsr, _as_array_dataset(labels, device), threshold, a_dense=a_dense
                )
            # CSR rows that are too dense (or dispatch disabled): densify
            # once through BSR — the only way this estimator consumes them.
            m, d = bsr.shape
            data = ArrayDataset(_bs.bsr_to_dense(bsr, device)[:m, :d])
        features = _as_array_dataset(data, device)
        targets = _as_array_dataset(labels, device)
        raw = features.data
        block = min(self.block_size, raw.shape[1])
        stream = self.host_streaming
        if stream is None:
            stream = _auto_host_streaming(raw, device)
        if stream:
            return self._fit_streaming(features, targets, block, device)
        return self._fit_in_core(features, targets, block, device)

    def _fit_streaming(
        self, features: ArrayDataset, targets: ArrayDataset, block: int,
        device: torch.device,
    ) -> BlockLinearMapper:
        """One feature block of the host matrix uploaded per update
        (``linalg.block_coordinate_descent_streaming``)."""
        raw = features.data.cpu()
        n = features.num_examples
        reg = self.reg if self.reg > 0 else _scale_aware_reg_floor(raw[: min(n, 4096)], n)
        w, mu_a, mu_b = linalg.block_coordinate_descent_streaming(
            raw, targets.data, reg=reg, num_epochs=self.num_iter, block_size=block,
            num_examples=n, device=device,
        )
        return BlockLinearMapper(w, block_size=block, intercept=mu_b, feature_mean=mu_a)

    def _fit_in_core(
        self, features: ArrayDataset, targets: ArrayDataset, block: int,
        device: torch.device,
    ) -> BlockLinearMapper:
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
        # their Gram rows/cols are zero and λ keeps the solve PD).
        d_pad = _round_up(d, block)
        if d_pad != d:
            xc = torch.nn.functional.pad(xc, (0, d_pad - d))
        w = linalg.block_coordinate_descent(
            xc, yc, reg=reg, num_epochs=self.num_iter, block_size=block
        )
        return BlockLinearMapper(w, block_size=block, intercept=mu_b, feature_mean=mu_a)

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
            threshold = _bs.density_threshold()
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
        threshold = _bs.density_threshold()
        if block_density_exceeds(host, block_shape, threshold):
            return None
        return ("sparse", BlockSparseMatrix.from_dense(host, block_shape), raw, threshold)

    def _fit_blocksparse(
        self,
        bsr: BlockSparseMatrix,
        targets: ArrayDataset,
        threshold: float,
        a_dense: Optional[torch.Tensor] = None,
    ) -> BlockLinearMapper:
        """Fit from block-sparse sufficient statistics (AᵀA, AᵀY, Σx, Σy),
        then the streamed fit's finish (:meth:`_finish_from_stats`)."""
        n = bsr.shape[0]
        y = targets.data.to(device=resolve_device(self.device), dtype=torch.float32)[:n]
        totals = _bs.bsr_gram_totals(bsr, y, a_dense=a_dense)
        return self._finish_from_stats(totals, n)


def _blocksparse_probe_bytes() -> int:
    """Ceiling on the host feature matrix the fast path will tile-probe.
    ``KEYSTONE_BLOCKSPARSE_PROBE_BYTES`` overrides."""
    return env_int("KEYSTONE_BLOCKSPARSE_PROBE_BYTES", int(512e6))


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
