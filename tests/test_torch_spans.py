"""The TimingTree's spans inside consensus and the STARK, on the CPU:
prove_step's tree holds each consensus step and each STARK phase in the
order the code runs them, children within their parents, and every node is
a profiler range named by its path, nested as the tree nests; a node's name
holds no path separator and no rate marker.

One proof for the module: the step 9 -> 10 of tests/test_pipeline.py's
seed-11 chain. The skip's spans are checked on test_torch_pipeline.py's
skip proof, and stark.prove's phase names against prove_streaming's in
test_torch_stark_stream.py, on proofs those modules already make."""

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from blobstreamx_tpu_torch.circuits import fixtures as fx, step
from blobstreamx_tpu_torch.prover import pipeline
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.utils.timing import TimingTree

torch.set_num_threads(1)
CFG = StarkConfig(rate_bits=2, cap_height=1, num_query_rounds=2, proof_of_work_bits=1, final_poly_len=8)
CONSENSUS = ["valsets", "signatures", "powers", "links"]
STARK = ["commit", "quotient", "openings", "deep", "fri", "queries"]


class _Kept(TimingTree):
    """A TimingTree that keeps the last instance made, for its nodes."""

    last = None

    def __init__(self, name="prove"):
        super().__init__(name)
        _Kept.last = self


def _user_ranges(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the ranges record_function
    opened while it ran). torch's own profiler (kineto, CPU activity, its
    configuration as torch.autograd.profiler.profile builds it), held to
    user-scope ranges: a full CPU trace of a step proof records about a
    million operator events and takes over a minute to read back."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import RecordScope

    prof = autograd_profiler.profile()
    _prepare_profiler(prof.config(), prof.kineto_activities)
    _enable_profiler(prof.config(), prof.kineto_activities, {RecordScope.USER_SCOPE})
    try:
        out = fn()
    finally:
        result = _disable_profiler()
    return out, [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in result.events()]


@pytest.fixture(scope="module")
def proof():
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75,
                              sign_heights={10})
    w = step.build_step_witness(chain, prev_height=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "TimingTree", _Kept)
        _, ranges = _user_ranges(lambda: pipeline.prove_step(w, CFG, device="cpu"))
    return {"tree": _Kept.last, "ranges": ranges}


def _child(tree, name):
    (node,) = [c for c in tree.root.children if c.name == name]
    return node


def test_step_consensus_and_stark_children_in_order(proof):
    tree = proof["tree"]
    assert [c.name for c in tree.root.children] == ["consensus", "trace", "stark"]
    assert [c.name for c in _child(tree, "consensus").children] == CONSENSUS
    assert [c.name for c in _child(tree, "stark").children] == STARK


def test_step_children_sum_within_their_parent(proof):
    def walk(node):
        if node.children:
            assert sum(c.seconds for c in node.children) <= node.seconds, node.name
        for c in node.children:
            walk(c)

    walk(proof["tree"].root)


def test_every_node_is_a_nested_profiler_range(proof):
    """One range a node path; each child's interval inside its parent's."""
    ranges = proof["ranges"]
    assert sorted(r[0] for r in ranges) == sorted(proof["tree"].flat())
    span = {name: (s, e) for name, s, e in ranges}
    for name, (s, e) in span.items():
        if "/" in name:
            ps, pe = span[name.rsplit("/", 1)[0]]
            assert ps <= s <= e <= pe, name


@pytest.mark.parametrize("name", ["consensus/links", "links (1000 headers)"])
def test_a_node_name_holds_no_separator_or_rate_marker(name):
    """"/" joins a path and " (" starts a rendered line's rate: a name with
    either would read as another node."""
    with pytest.raises(ValueError):
        TimingTree(name)
    tree = TimingTree("prove_step")
    with pytest.raises(ValueError):
        with tree.scope(name):
            pass
    assert tree.root.children == []
