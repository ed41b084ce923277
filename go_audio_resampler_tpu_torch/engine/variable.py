"""Variable-rate resampling: the libsoxr ``SOXR_VR`` capability.

PyTorch counterpart of the JAX package's ``engine/variable.py``.  The Go
reference implements only constant-rate conversion; libsoxr adds a
variable-rate mode (``soxr_set_io_ratio`` with linear slew) for glissandi,
clock-drift correction and live rate tracking.

Design (the host plans, the device computes):

- The **host** owns the exact position walk, copied from the JAX package
  in float64 numpy.  Output k reads input position ``p_k``; the io-ratio
  ``r`` (input samples per output sample) slews linearly toward the
  target set by :meth:`VariableRateResampler.set_io_ratio`.  Positions are
  a closed form of the output index from the last ratio event (the
  anchor): ``p(k) = anchor + su*k + du*k(k-1)/2`` during a slew, linear
  after, never an accumulated sum, so the emitted stream does not depend
  on how the input is chunked, and anchors rebase only at deterministic
  points (ratio events, slew completion, fixed k thresholds).
- The **device** runs one step per block: for ``'vr-hq'`` the 2x
  half-band prestage (the K1 kernel on the card, its banded operator
  prepared once per resampler), then the 4-sample windows of ``[carry |
  u]`` at the host's window starts, weighted by the Catmull-Rom basis at
  the host's fractions (:func:`_cubic_basis`, evaluated on the host in
  the resampler's dtype) and summed in a fixed order.  Every step has
  the same shapes (``[S, block]`` in, ``[S, cap]`` out), and each output
  is one fixed-order sum, so the bits depend neither on the chunking nor
  on the route (:meth:`process` or :meth:`process_device`).  The JAX
  package's banded tile matmul (``_vr_scan``) is no Pallas kernel; its
  sum of four non-zero products is this one.

Two quality modes:

- ``'vr'``: 4-point cubic straight on the input stream (libsoxr VR class:
  cubic interpolation).
- ``'vr-hq'``: the input is first 2x-upsampled with the engine's DFT
  half-band prestage (``filterdesign.design_dft_upsample``), then the
  cubic walk runs on the image-free 2x stream, cutting interpolation
  error by the image attenuation of the half-band.  The prestage group
  delay is compensated in the position model, so both modes are
  time-aligned.

Reference anchors: cubic kernel parity with cubic.go:75-90 (via
stages.hermite4); the prestage is dft_stage.go:156-338's filter.  The
API shape (io_ratio, linear slew over N outputs) follows soxr.h
soxr_set_io_ratio.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..filterdesign import params as fdp
from ..ops import convolve
from ..ops.precision import dot_precision, tiered_matmul
from .stages import prestage_apply

MIN_IO_RATIO = 1.0 / 256.0
MAX_IO_RATIO = 256.0


#: outputs per tile of the JAX package's banded matmul; the per-block
#: output capacity is a whole number of them
VR_TILE = 128


def _cubic_basis(fr: np.ndarray) -> np.ndarray:
    """Catmull-Rom basis weights K0..K3 at fraction ``fr`` (stacked last),
    in ``fr``'s dtype.

    The per-tap expansion of stages.hermite4 (cubic.go:75-90): pushing
    unit taps through its a/b/c algebra gives, exactly,
      K0 = ((-f/6 + 1/2)f - 1/3)f          K1 = ((f/2 - 1)f - 1/2)f + 1
      K2 = ((-f/2 + 1/2)f + 1)f            K3 = ((f/6)f - 1/6)f
    At f == 0 this is the exact one-hot (0,1,0,0), so integer positions
    reproduce input samples bit for bit.
    """
    one = np.ones((), fr.dtype)
    k0 = ((-fr / 6.0 + 0.5) * fr - (1.0 / 3.0)) * fr
    k1 = ((fr / 2.0 - 1.0) * fr - 0.5) * fr + one
    k2 = ((-fr / 2.0 + 0.5) * fr + 1.0) * fr
    k3 = ((fr / 6.0) * fr - (1.0 / 6.0)) * fr
    return np.stack([k0, k1, k2, k3], axis=-1)


def _tap_sum(w: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """sum_t w[s, c, t] * k[c, t] over the 4 taps in a fixed order:
    elementwise products and sums, so the bits do not depend on the
    shape (as a library matmul's algorithm choice would)."""
    w0, w1, w2, w3 = w.unbind(-1)
    k0, k1, k2, k3 = k.unbind(-1)
    return ((w0 * k0 + w1 * k1) + w2 * k2) + w3 * k3


class VariableRateResampler:
    """Streaming variable-rate resampler (soxr.h variable-rate analog).

    Parameters
    ----------
    max_ratio:
        Upper bound on the *output/input* rate ratio ever requested
        (soxr requires the same bound at create time for VR); sizes the
        per-block output capacity.  Must lie in [1/256, 256].
    io_ratio:
        Initial input-samples-per-output-sample ratio (soxr convention:
        ``input_rate / output_rate``).
    batch:
        Number of independent streams on the leading axis.
    block:
        Internal device block size in input samples.
    dtype:
        float32 (the card's type) or float64 (``device='cpu'`` only).
    quality:
        ``'vr'`` (cubic on the input) or ``'vr-hq'`` (cubic on a 2x
        half-band upsampled stream).
    device:
        Where the streams' state and the steps live; ``'cuda'`` by
        default, which raises without a GPU (pass ``device='cpu'``).

    float32 products run at the process-wide tier
    ``GAR_TPU_MATMUL_PRECISION`` (``ops/precision.py``), read when the
    resampler is built.
    """

    PRESTAGE_FACTOR = 2

    def __init__(self, max_ratio: float, io_ratio: float = 1.0, *,
                 batch: int = 1, block: int = 2048, dtype=np.float32,
                 quality: str = 'vr', device='cuda'):
        if not (MIN_IO_RATIO <= max_ratio <= MAX_IO_RATIO):
            raise ValueError("max_ratio out of [1/256, 256]")
        if quality not in ('vr', 'vr-hq'):
            raise ValueError("quality must be 'vr' or 'vr-hq'")
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                "VariableRateResampler: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
            raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")
        if self.device.type == 'cuda' and self.dtype != np.float32:
            raise ValueError("VariableRateResampler: the card computes "
                             "float32; float64 runs on device='cpu'")
        self._tdtype = (torch.float32 if self.dtype == np.float32
                        else torch.float64)
        self._tier = dot_precision(None)
        self.max_ratio = float(max_ratio)
        self.batch = int(batch)
        self.block = int(block)
        self.quality = quality

        self.factor = self.PRESTAGE_FACTOR if quality == 'vr-hq' else 1
        self._pre_band = None
        if quality == 'vr-hq':
            pre = fdp.design_dft_upsample(self.factor, fdp.Quality.HIGH)
            self._pre_coeffs = torch.as_tensor(
                pre.phase_coeffs, dtype=self._tdtype, device=self.device)
            self._pre_t1 = pre.taps_per_phase
            # u[j] carries input time (j - delay_u) / factor: each phase
            # FIR spans T1 inputs (center (T1-1)/2), so on the u grid the
            # group delay is factor*(T1-1)/2 (integer for factor 2).
            self._delay_u = self.factor * (self._pre_t1 - 1) // 2
            if self.device.type == 'cuda':
                # One K1 operator for every step's T1-1+block samples
                # (EngineCore._pre_band's role), prepared at the tier.
                self._pre_band = convolve.band_operator(
                    self._pre_coeffs, self._pre_t1 - 1 + self.block, 1,
                    self._tdtype, self.device, self._tier)
        else:
            self._pre_coeffs = None
            self._pre_t1 = 1
            self._delay_u = 0

        # Output capacity per input block: outputs per input sample is
        # bounded by max_ratio regardless of the prestage factor.  Rounded
        # up to whole VR_TILE tiles, as the JAX package sizes it.
        self.cap = -(-(int(math.ceil(self.block * self.max_ratio)) + 4)
                     // VR_TILE) * VR_TILE

        self._validate_ratio(io_ratio)
        # The initial ratio must respect max_ratio exactly like every
        # set_io_ratio() target: the per-block output capacity is sized
        # from max_ratio, so a faster initial ratio would overflow the
        # walk mid-process (an internal AssertionError) instead of
        # failing loudly here at construction.
        if 1.0 / io_ratio > self.max_ratio + 1e-12:
            raise ValueError(
                f"initial io_ratio {io_ratio} exceeds max_ratio "
                f"{self.max_ratio} (output/input {1.0 / io_ratio:.4f})")
        self._init_r = float(io_ratio)
        self.reset()

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy dtype of host input and output (the streaming
        protocol's name for it, as ``EngineCore`` has it)."""
        return self.dtype

    # -- ratio control ----------------------------------------------------

    @staticmethod
    def _validate_ratio(io_ratio: float) -> None:
        if not (MIN_IO_RATIO <= io_ratio <= MAX_IO_RATIO):
            raise ValueError("io_ratio out of [1/256, 256]")

    def set_io_ratio(self, io_ratio: float, slew_len: int = 0) -> None:
        """Change the in/out ratio, slewing over ``slew_len`` outputs.

        soxr.h soxr_set_io_ratio semantics: with slew_len == 0 the change
        is immediate; otherwise the ratio moves linearly to the target
        over the next ``slew_len`` emitted output samples.
        """
        self._validate_ratio(io_ratio)
        if 1.0 / io_ratio > self.max_ratio + 1e-12:
            raise ValueError(
                f"io_ratio {io_ratio} exceeds construction-time max_ratio "
                f"{self.max_ratio} (output/input {1.0 / io_ratio:.4f})")
        su_cur = self._step_at(self._k)   # current per-output u step
        self._rebase()                    # anchor at the ratio event
        target_su = float(self.factor) * float(io_ratio)
        if slew_len <= 0:
            self._su = target_su
            self._du = 0.0
            self._slew_n = 0
        else:
            self._su = su_cur
            self._du = (target_su - su_cur) / float(slew_len)
            self._slew_n = int(slew_len)
        self._su_end = target_su

    def get_io_ratio(self) -> float:
        return self._step_at(self._k) / float(self.factor)

    # -- closed-form position model ---------------------------------------
    #
    # From the last anchor (output index k = 0 at u position _anchor):
    #   k <= _slew_n:  p(k) = anchor + su*k + du*k(k-1)/2,
    #                  step(k) = su + k*du
    #   k >  _slew_n:  p(k) = p(_slew_n) + su_end*(k - _slew_n),
    #                  step(k) = su_end
    # Positions are always evaluated from (anchor, k), never accumulated
    # sample to sample, so chunking cannot perturb rounding.

    _REBASE_K = 1 << 20

    def _step_at(self, k: int) -> float:
        if k < self._slew_n:
            return self._su + k * self._du
        return self._su_end

    def _pos_at(self, k: float) -> float:
        if k <= self._slew_n:
            return self._anchor + self._su * k + self._du * (k * (k - 1.0)
                                                             / 2.0)
        ps = self._anchor + self._su * self._slew_n \
            + self._du * (self._slew_n * (self._slew_n - 1.0) / 2.0)
        return ps + self._su_end * (k - self._slew_n)

    def _rebase(self) -> None:
        """Re-anchor the closed form at the current output index."""
        self._anchor = self._pos_at(self._k)
        if self._k >= self._slew_n:
            self._su = self._su_end
            self._du = 0.0
            self._slew_n = 0
        else:
            self._su = self._step_at(self._k)
            self._slew_n -= self._k
        self._k = 0

    # -- state ------------------------------------------------------------

    def _zeros(self, width: int) -> torch.Tensor:
        return torch.zeros((self.batch, width), dtype=self._tdtype,
                           device=self.device)

    def reset(self) -> None:
        self._hold = np.zeros((self.batch, 0), dtype=self.dtype)
        self._carry = self._zeros(3)
        # 'vr' mode keeps an empty prestage state.
        pre_w = self._pre_t1 - 1 if self.quality == 'vr-hq' else 0
        self._pre_carry = self._zeros(pre_w)
        # Output at input time t sits at u position factor*t + delay_u;
        # the first output is at input time 0.
        self._anchor = float(self._delay_u)
        self._k = 0                       # outputs since the anchor
        self._su = float(self.factor) * self._init_r
        self._su_end = self._su
        self._du = 0.0
        self._slew_n = 0
        self._u_fed = 0                   # u-samples fed to the device
        self._in_fed = 0                  # input samples fed so far
        self.samples_in = 0
        self.samples_out = 0

    # -- host walk --------------------------------------------------------

    def _walk(self, data_u: int, pos_limit: float):
        """Emit positions while the 4-sample window is covered by the fed
        u-stream (floor(p)+2 <= data_u-1) and p < pos_limit; advance the
        output index past the emitted outputs.

        Returns (ip int64 array, frac float64 array).  All positions are
        evaluated closed-form from the anchor (see the model above), so
        identical output indices always get bit-identical positions.
        """
        ips, fracs = [], []
        while True:
            p0 = self._pos_at(self._k)
            if math.floor(p0) + 2 > data_u - 1 or p0 >= pos_limit:
                break
            in_slew = self._k < self._slew_n
            # Run length never crosses a rebase boundary, so folds happen
            # at exact k values and chunking cannot shift their rounding.
            n_run = (self._slew_n - self._k) if in_slew \
                else (self._REBASE_K - self._k)
            step_now = self._step_at(self._k)
            step_end = self._step_at(self._k + n_run) if in_slew \
                else self._su_end
            min_step = min(step_now, step_end)
            if min_step <= 0:
                raise RuntimeError("non-positive ratio during slew")
            span = min(float(data_u - 3) - p0, pos_limit - p0)
            n = min(n_run, max(int(span / min_step) + 2, 1))
            kk = self._k + np.arange(n, dtype=np.float64)
            if in_slew:
                pos = (self._anchor + self._su * kk
                       + self._du * (kk * (kk - 1.0) / 2.0))
            else:
                sn = float(self._slew_n)
                ps = (self._anchor + self._su * sn
                      + self._du * (sn * (sn - 1.0) / 2.0))
                pos = ps + self._su_end * (kk - sn)
            ok = ((np.floor(pos).astype(np.int64) + 2 <= data_u - 1)
                  & (pos < pos_limit))
            n_emit = int(ok.sum())       # both conditions fail monotonely
            if n_emit == 0:
                break
            pos = pos[:n_emit]
            ip = np.floor(pos).astype(np.int64)
            ips.append(ip)
            fracs.append(pos - ip)
            self._k += n_emit
            # Deterministic rebase points only: slew completion exactly at
            # k == slew_n, magnitude fold exactly at k == _REBASE_K.
            if self._slew_n and self._k == self._slew_n:
                self._rebase()
            elif self._slew_n == 0 and self._k == self._REBASE_K:
                self._anchor += self._su_end * self._REBASE_K
                self._k = 0
            if n_emit < n:
                break
        if not ips:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.float64))
        return np.concatenate(ips), np.concatenate(fracs)

    # -- processing -------------------------------------------------------

    def _put(self, arr, batch_axis: int):
        """Device placement hook (overridden by a sharded subclass)."""
        return arr

    def _walk_block(self, pos_limit: float):
        """Host walk for one full block; returns (idx, fr, va, n)."""
        nu = self.factor * self.block
        hist_off = self._u_fed - 3       # u index of histbuf[0]
        self._u_fed += nu
        ip, frac = self._walk(self._u_fed, pos_limit)
        n = len(ip)
        if n > self.cap:
            # Cannot happen while io_ratio respects max_ratio; fail
            # loudly rather than silently dropping outputs.
            raise AssertionError(
                f"internal: VR walk emitted {n} > cap {self.cap}")
        idx = np.zeros(self.cap, dtype=np.int32)
        fr = np.zeros(self.cap, dtype=np.float64)
        va = np.zeros(self.cap, dtype=np.float32)
        idx[:n] = (ip - 1) - hist_off    # window = u[ip-1 .. ip+2]
        fr[:n] = frac
        va[:n] = 1.0
        assert n == 0 or (idx[:n].min() >= 0
                          and int(idx[:n].max()) + 4 <= 3 + nu), \
            "internal: VR window outside histbuf"
        return idx, fr, va, n

    def _step(self, x: torch.Tensor, idx: np.ndarray,
              fr: np.ndarray) -> torch.Tensor:
        """One block on the device (the body of the JAX package's
        ``_vr_scan``): x [S, block] -> y [S, cap], of which the walk's
        valid prefix is kept (the validity mask).  ``idx`` and ``fr`` are
        the host walk's window starts into ``[carry | u]`` and fractions,
        zero past the valid prefix."""
        if self.factor > 1:
            xext = torch.cat([self._pre_carry, x], dim=1)
            u = prestage_apply(self._pre_coeffs, xext, self.factor,
                               self._tier, band=self._pre_band)
            self._pre_carry = xext[:, x.shape[1]:].contiguous()
        else:
            u = x
        histbuf = torch.cat([self._carry, u], dim=1)
        # The windows' sample indices and the basis, formed on the host
        # (the basis in the resampler's dtype, as the JAX package forms
        # it on the device), then copied up.
        cols = idx.astype(np.int64)[:, None] + np.arange(4)
        k = _cubic_basis(fr.astype(self.dtype))
        w = histbuf[:, self._upload(cols)]                  # [S, cap, 4]
        y = tiered_matmul(w, self._upload(k), self._tier, _tap_sum)
        self._carry = histbuf[:, -3:].contiguous()
        return y

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the resampler's device.  On the card it is
        staged in pinned memory and copied without waiting for the
        stream (a copy from pageable memory would), so the host queues
        block after block; the caching host allocator keeps the staging
        buffer until its copy is done."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != 'cuda':
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _run_blocks(self, blocks, pos_limit: float, out: str = 'host'):
        """Run K full blocks one step each; ``blocks`` is ``(get, K)``,
        ``get(i)`` block i as [S, block] on the device.

        ``out='host'`` copies the valid prefixes back in one transfer;
        ``out='device'`` concatenates them on the device and returns one
        tensor: every slice bound comes from the host-side closed-form
        walk, so nothing synchronizes.
        """
        get, k = blocks
        ys = []
        for i in range(k):
            idx, fr, _va, n = self._walk_block(pos_limit)
            y = self._step(self._put(get(i), 0), idx, fr)
            self.samples_out += n
            if n:
                ys.append(y[:, :n])
        if ys:
            y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
        else:
            y = self._put(self._zeros(0), 0)
        if out == 'device':
            return y
        return y.cpu().numpy()

    def _host_blocks(self, blocks: np.ndarray):
        """``_run_blocks``' view of host blocks [K, S, block]: each copied
        up when its step runs."""
        return (lambda i: self._upload(blocks[i]), blocks.shape[0])

    def process(self, x: np.ndarray) -> np.ndarray:
        """Resample a [batch, n] (or [n] mono) chunk; returns [batch, m].

        The emitted count m varies with the ratio trajectory.  Input is
        accumulated into fixed device blocks, so the emitted stream is
        bit-exact invariant to how the caller chunks the input (the
        device always sees identical block boundaries).
        """
        x = np.asarray(x, dtype=self.dtype)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {x.shape[0]}")
        self.samples_in += x.shape[1]
        self._in_fed += x.shape[1]
        self._hold = np.concatenate([self._hold, x], axis=1)
        k = self._hold.shape[1] // self.block
        if k == 0:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        blocks = np.stack(
            [self._hold[:, i * self.block:(i + 1) * self.block]
             for i in range(k)])
        self._hold = self._hold[:, k * self.block:]
        return self._run_blocks(self._host_blocks(blocks), math.inf)

    def _flush_blocks(self, pos_limit: float):
        """The blocks that drain a flush: the held input zero-padded to
        whole blocks until the u-stream covers every emittable position
        plus the cubic lookahead (an exact count, not a feed-until-covered
        loop); None when nothing is left to emit."""
        hold = self._hold
        self._hold = np.zeros((self.batch, 0), dtype=self.dtype)
        if self._pos_at(self._k) >= pos_limit:
            return None
        need_u = max(int(pos_limit) + 3 - self._u_fed, 0)
        k = -(-need_u // (self.factor * self.block))
        k = max(k, 1 if hold.shape[1] else 0)
        if k == 0:
            return None
        pad_first = self.block - hold.shape[1]
        first = np.concatenate(
            [hold, np.zeros((self.batch, pad_first), dtype=self.dtype)],
            axis=1)
        return np.concatenate(
            [first[None],
             np.zeros((k - 1, self.batch, self.block), dtype=self.dtype)])

    def flush(self) -> np.ndarray:
        """Drain outputs whose positions lie inside the real input.

        Canonical contract: every output with (delay-compensated) input
        position p < n_inputs is emitted; the cubic lookahead window is
        satisfied by zero padding (positions beyond the real input are
        blocked by the limit, exactly like the constant-rate flush).
        """
        pos_limit = float(self.factor * self._in_fed + self._delay_u)
        blocks = self._flush_blocks(pos_limit)
        if blocks is None:
            return np.zeros((self.batch, 0), dtype=self.dtype)
        return self._run_blocks(self._host_blocks(blocks), pos_limit)

    # -- device-resident serving (no host syncs) --------------------------

    @property
    def device_chunk_multiple(self) -> int:
        """Input granularity for :meth:`process_device` (the VR block)."""
        return self.block

    def process_device(self, x) -> torch.Tensor:
        """Resample a chunk on the device; returns a tensor there.

        The VR twin of EngineCore.process_device: although the output
        count varies with the ratio trajectory, the closed-form anchored
        walk computes every count and slice bound on the host (the device
        only evaluates sample values), so the call never synchronizes, even
        mid-slew.  ``x`` is (or is copied to) a ``[batch, k*block]`` tensor
        on the resampler's device; its k blocks run one step each and the
        valid prefixes are concatenated on the device.
        """
        x = torch.as_tensor(x).to(device=self.device, dtype=self._tdtype)
        if x.dim() == 1:
            x = (x.expand(self.batch, x.shape[0]) if self.batch > 1
                 else x[None, :])
        if x.shape[0] != self.batch:
            raise ValueError(f"expected batch {self.batch}, got {x.shape[0]}")
        n = int(x.shape[1])
        if self._hold.shape[1]:
            raise RuntimeError(
                "process_device: host-buffered input pending from a prior "
                "process() call; feed block multiples there, or reset()")
        if n % self.block:
            raise ValueError(
                f"process_device chunk width {n} is not a multiple of "
                f"block={self.block}")
        if n == 0:
            return self._put(self._zeros(0), 0)
        self.samples_in += n
        self._in_fed += n
        b = self.block
        return self._run_blocks((lambda i: x[:, i * b:(i + 1) * b], n // b),
                                math.inf, out='device')

    def flush_device(self) -> torch.Tensor:
        """Drain remaining outputs on the device (device twin of flush)."""
        pos_limit = float(self.factor * self._in_fed + self._delay_u)
        blocks = self._flush_blocks(pos_limit)
        if blocks is None:
            return self._put(self._zeros(0), 0)
        return self._run_blocks(self._host_blocks(blocks), pos_limit,
                                out='device')

    def stream(self, chunks, out: str = 'host'):
        """Pipelined VR streaming (EngineCore.stream twin): chunk k+1 is
        queued before chunk k is copied back, so the transfer rides under
        the next chunk's compute.  Accepts chunks of any widths (a host
        buffer carves block multiples); yields the resampled stream ending
        with the flush tail.  ``out='device'`` yields tensors on the
        resampler's device without copying them back.  Ratio changes via
        :meth:`set_io_ratio` between pulls apply from the next chunk.

        One protocol serves both engines (streaming.pipelined_stream),
        including the ordered yield of anything the sub-block remainder
        emits when host input was already buffered before the stream
        started.
        """
        from .streaming import pipelined_stream

        yield from pipelined_stream(self, chunks, out, self.block)

    # -- introspection ----------------------------------------------------

    def get_statistics(self) -> dict:
        return {"samplesIn": self.samples_in, "samplesOut": self.samples_out,
                "ioRatio": self.get_io_ratio(),
                "slewRemaining": max(self._slew_n - self._k, 0)}
