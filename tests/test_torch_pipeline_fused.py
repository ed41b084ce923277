"""PyTorch port vs JAX package: ``pipeline/fused.py``, the host layer of
whole-pipeline fusion.

Every operator the port builds (``banded_from_plan``, ``compose``,
``fuse_chain``) is held bit-equal to the JAX package's on the same plans
(carried across as arrays, so both read the very same filter banks): P, I,
W, lam, R and the aperiodic head rows, the folded counts, the length
model of a composite and its fingerprint.  The numpy apply of an operator
is held to the JAX package's to 1e-12.
"""

import dataclasses
import functools

import numpy as np
import pytest

from go_audio_resampler_tpu.engine.plan import plan_engine as jplan_engine
from go_audio_resampler_tpu.filterdesign import Quality as JQuality
from go_audio_resampler_tpu.pipeline import fused as jfused
from go_audio_resampler_tpu_torch import pipeline
from go_audio_resampler_tpu_torch.engine import plan_from_arrays
from go_audio_resampler_tpu_torch.engine.counts import LengthModel
from go_audio_resampler_tpu_torch.pipeline import fused as tfused

OP_FIELDS = ("P", "I", "W", "R", "lam", "lengths", "head")


@functools.lru_cache(maxsize=None)
def _plans(a, b, q, aa=False):
    """The JAX package's plan and the port's copy of it."""
    jp = jplan_engine(float(a), float(b), JQuality(q), aa)
    return jp, plan_from_arrays({f: getattr(jp, f)
                                 for f in jp.__dataclass_fields__})


def _fields(op) -> dict:
    return {f: getattr(op, f) for f in OP_FIELDS}


def _same_lengths(t, j):
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert isinstance(a, LengthModel)
        assert dataclasses.asdict(a) == {
            f.name: getattr(b, f.name) for f in dataclasses.fields(b)}


def _same_op(t, j):
    """The port's operator ``t`` bit-equal to the JAX package's ``j``."""
    assert isinstance(t, tfused.BandedOp)
    assert (t.P, t.I, t.W, t.lam, t.n_head) == (j.P, j.I, j.W, j.lam,
                                                j.n_head)
    assert t.R.dtype == np.float64 and np.array_equal(t.R, j.R)
    if j.head is None:
        assert t.head is None
    else:
        assert t.head.dtype == np.float64 and np.array_equal(t.head, j.head)
    assert t.ratio == j.ratio
    _same_lengths(t.lengths, j.lengths)


# -- banded_from_plan ------------------------------------------------------------

@pytest.mark.parametrize("a,b,q,aa", [
    (48000, 48000, 3, False),    # dft_up, factor 1 (pass-through)
    (48000, 96000, 3, False),    # dft_up, factor 2
    (48000, 24000, 3, False),    # decimate, factor 2
    (48000, 12000, 4, False),    # decimate, factor 4
    (48000, 32000, 3, False),    # exact two_stage 2/3
    (44100, 48000, 4, False),    # exact two_stage CD->DAT
    (48000, 44100, 3, True),     # exact two_stage with strict antialias
    (48000, 32000, 4, True),
])
def test_banded_from_plan_bit_equal(a, b, q, aa):
    jp, tp = _plans(a, b, q, aa)
    assert (tp.aa_taps > 0) == aa
    j, t = jfused.banded_from_plan(jp), tfused.banded_from_plan(tp)
    _same_op(t, j)
    assert (t.lam > 0) == aa


@pytest.mark.parametrize("a,b,q", [
    (44100, 48001, 3),           # non-exact two_stage
    (48000, 44099, 3),
    (44100, 48000, 0),           # cubic (QUICK)
])
def test_banded_from_plan_none(a, b, q):
    jp, tp = _plans(a, b, q)
    assert jfused.banded_from_plan(jp) is None
    assert tfused.banded_from_plan(tp) is None


# -- compose and fuse_chain --------------------------------------------------------

#: tests/test_pipeline_fused.py's chains: (in, out, quality, strict aa).
CHAINS = [
    [(48000, 24000, 3, False), (24000, 12000, 3, False)],
    [(48000, 24000, 3, False), (24000, 16000, 3, False)],
    [(48000, 96000, 1, False), (96000, 64000, 1, False)],
    [(48000, 24000, 4, False), (24000, 12000, 4, False),
     (12000, 8000, 4, False)],
]
#: Chains whose composite has an aperiodic head: a downstream strict-aa
#: stage; an upstream P > 1 into it (floored division); head on head; and
#: MEDIUM's chain that pins the ceil of n_head.
HEAD_CHAINS = [
    [(48000, 24000, 3, False), (24000, 22050, 3, True)],
    [(24000, 48000, 3, False), (48000, 44100, 3, True)],
    [(48000, 24000, 3, False), (24000, 22050, 3, True),
     (22050, 16000, 3, True)],
    [(48000, 24000, 2, False), (24000, 22050, 2, True)],
]


@functools.lru_cache(maxsize=None)
def _chain(key):
    """(the JAX composite, the port's) of a chain, step by step."""
    pairs = [_plans(*stage) for stage in key]
    jops = [jfused.banded_from_plan(j) for j, _ in pairs]
    tops = [tfused.banded_from_plan(t) for _, t in pairs]
    j, t = jops[0], tops[0]
    for jo, to in zip(jops[1:], tops[1:]):
        j, t = jfused.compose(j, jo), tfused.compose(t, to)
    return j, t


def _key(chain):
    return tuple(tuple(s) for s in chain)


@pytest.mark.parametrize("chain", CHAINS + HEAD_CHAINS)
def test_compose_bit_equal(chain):
    j, t = _chain(_key(chain))
    _same_op(t, j)
    assert (t.head is not None) == (chain in HEAD_CHAINS)


@pytest.mark.parametrize("chain", CHAINS[:2] + HEAD_CHAINS[:1])
def test_fuse_chain_bit_equal(chain):
    pairs = [_plans(*stage) for stage in chain]
    j = jfused.fuse_chain([p for p, _ in pairs])
    t = tfused.fuse_chain([p for _, p in pairs])
    _same_op(t, j)
    _same_op(t, _chain(_key(chain))[1])


def test_fuse_chain_refusals(monkeypatch):
    """None for an empty chain, a non-periodic stage, and a composite past
    MAX_FUSED_WIDTH, as the JAX package refuses them."""
    assert tfused.MAX_FUSED_WIDTH == jfused.MAX_FUSED_WIDTH == 65536
    pairs = [_plans(*stage) for stage in CHAINS[0]]
    walk = _plans(44100, 48001, 3)
    for tchain, jchain in (([], []), ([pairs[0][1], walk[1]],
                                      [pairs[0][0], walk[0]])):
        assert tfused.fuse_chain(tchain) is None
        assert jfused.fuse_chain(jchain) is None
    width = _chain(_key(CHAINS[0]))[1].W
    monkeypatch.setattr(tfused, "MAX_FUSED_WIDTH", width - 1)
    monkeypatch.setattr(jfused, "MAX_FUSED_WIDTH", width - 1)
    assert tfused.fuse_chain([t for _, t in pairs]) is None
    assert jfused.fuse_chain([j for j, _ in pairs]) is None
    monkeypatch.setattr(tfused, "MAX_FUSED_WIDTH", width)
    assert tfused.fuse_chain([t for _, t in pairs]) is not None


def test_compose_consuming_no_input_raises():
    op = tfused.BandedOp(P=1, I=1, W=1, R=np.ones((1, 1)), lam=5,
                         lengths=())
    with pytest.raises(ValueError, match="consumes no input"):
        tfused.compose(op, op)


@pytest.mark.parametrize("chain", [CHAINS[1], CHAINS[2], HEAD_CHAINS[0],
                                   HEAD_CHAINS[2]])
def test_count_folding_and_length_model(chain):
    """count, canonical and flush_pad over n in 0..5000 equal the JAX
    package's."""
    j, t = _chain(_key(chain))
    jl, tl = jfused.BandedLengthModel(j), tfused.BandedLengthModel(t)
    ns = range(0, 5001)
    assert [t.count(n) for n in ns] == [j.count(n) for n in ns]
    assert [tl.canonical(n) for n in ns] == [jl.canonical(n) for n in ns]
    assert [tl.flush_pad(n) for n in ns] == [jl.flush_pad(n) for n in ns]
    assert tl.drop_prefix() == jl.drop_prefix() == 0


@pytest.mark.parametrize("chain", [CHAINS[0], HEAD_CHAINS[0]])
def test_banded_plan_matches(chain):
    j, t = _chain(_key(chain))
    jp, tp = jfused.BandedPlan(j, 0.25, latency=7), tfused.BandedPlan(
        t, 0.25, latency=7)
    assert tp.fingerprint == jp.fingerprint
    assert tp.fingerprint[0] == tp.kind == "banded"
    for name in ("ratio", "num_phases", "aa_taps"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("latency", "filter_length", "algorithm"):
        assert getattr(tp, name)() == getattr(jp, name)(), name
    assert tp.estimate_output(12345) == jp.estimate_output(12345)
    # Another operator of the same shape has another fingerprint.
    other = dataclasses.replace(t, R=t.R * (1 + 2 ** -40))
    assert tfused.BandedPlan(other, 0.25).fingerprint != tp.fingerprint


@pytest.mark.parametrize("chain", [CHAINS[2], HEAD_CHAINS[1]])
def test_banded_op_from_arrays_round_trip(chain):
    """An operator of the JAX package carried into the port equals the
    port's own, with its arrays copied."""
    j, t = _chain(_key(chain))
    built = tfused.banded_op_from_arrays(_fields(j))
    _same_op(built, j)
    _same_op(built, t)
    assert built.R is not j.R
    again = tfused.banded_op_from_arrays(_fields(built))
    _same_op(again, j)
    head_free = tfused.banded_op_from_arrays({**_fields(j), "head": None})
    assert head_free.head is None and head_free.n_head == 0


@pytest.mark.parametrize("chain", CHAINS[1:3] + HEAD_CHAINS[:2])
@pytest.mark.parametrize("n", [1, 64, 1111, 4096])
def test_apply_matches(chain, n):
    j, t = _chain(_key(chain))
    x = np.random.default_rng(n).normal(size=(2, n))
    want, got = j.apply(x), t.apply(x)
    assert got.shape == want.shape == (2, t.count(n))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert t.apply(x, count=0).shape == (2, 0)


def test_package_exports():
    """``pipeline`` exports what the JAX package's does (the planner and
    the FIFO) and the fusion layer."""
    from go_audio_resampler_tpu import pipeline as jpipeline
    assert set(pipeline.__all__) == set(jpipeline.__all__) | {
        "SampleFIFO", "MAX_FUSED_WIDTH", "BandedOp", "BandedLengthModel",
        "BandedPlan", "banded_from_plan", "banded_op_from_arrays",
        "compose", "fuse_chain"}
    assert pipeline.fuse_chain is tfused.fuse_chain
