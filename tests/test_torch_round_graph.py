"""The decode round's graph runner (``spec/round_graph.py``) on the CPU:
CPU tensors and a mesh keep the eager rounds; a stand-in for the CUDA
graph (capture records the round and leaves the state as it was, a replay
runs it again) gives the eager tokens bit for bit, counts the captured
launches once a replay, captures once an engine across sessions and again
when the state's buffers move.  Torch only, float32, toy widths."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vispec_tpu_torch import configs
from vispec_tpu_torch.models import draft as draft_mod
from vispec_tpu_torch.models import llama
from vispec_tpu_torch.models import medusa as medusa_mod
from vispec_tpu_torch.spec import batch, round_graph
from vispec_tpu_torch.spec import loop as spec_loop
from vispec_tpu_torch.spec.serving import ServingEngine
from vispec_tpu_torch.spec.spec_model import SpecModel
from vispec_tpu_torch.utils import profiling

CPU = torch.device("cpu")
WIDTHS = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=512)
SPEC = configs.SpecConfig(total_tokens=12, depth=3, top_k=4)
NO_EOS = 10**6


def _model(medusa: bool = False) -> SpecModel:
    gen = torch.Generator().manual_seed(0)
    tcfg = configs.LlamaConfig(num_hidden_layers=2, **WIDTHS)
    dcfg = configs.DraftConfig(num_q=2, **WIDTHS)
    tparams = llama.init_params(tcfg, gen, CPU, torch.float32)
    dparams = draft_mod.init_params(dcfg, gen, CPU, torch.float32)
    dparams["embed"] = tparams["embed"]
    kw = {}
    if medusa:
        heads = medusa_mod.init_params(WIDTHS["hidden_size"], CPU, torch.float32)
        kw["mparams"] = {k: 0.05 * torch.randn(v.shape, generator=gen)
                         for k, v in heads.items()}
    return SpecModel(tcfg, dcfg, SPEC, tparams, dparams, max_len=256, dtype=torch.float32,
                     device=CPU, eos_token_id=NO_EOS, **kw)


@pytest.fixture(scope="module")
def text_model():
    return _model()


def _prompts(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(5, 200, rng.integers(8, 24)).tolist() for _ in range(n)]


def _leaves(states):
    return round_graph._leaves(states)


class StandIn:
    """A CUDA graph's behaviour on the CPU: capture runs the round's Python
    (so the wrappers' counters move as they would) but leaves the buffers
    and the counters as they were; a replay runs the round again with the
    counters untouched, as a replay runs no Python."""

    def __init__(self, fn, buffers):
        self.fn = fn
        saved = [t.clone() for t in buffers]
        fn()
        for t, s in zip(buffers, saved):
            t.copy_(s)

    def replay(self):
        counts = round_graph.launch_counts()
        self.fn()
        for (f, a), v in counts.items():
            setattr(f, a, v)


def _stand_in(buffers):
    """A ``RoundGraph`` that engages on the CPU with the stand-in graph;
    ``buffers()`` gives the tensors a capture must leave as they were."""
    made = []

    def record(fn):
        made.append(StandIn(fn, buffers()))
        return made[-1]

    graph = round_graph.RoundGraph(record=record, device="cpu")
    return graph, made


def _states(model, n=3, sampled=False):
    sampling = spec_loop.SamplingParams(1.0 if sampled else 0.0)
    reqs = batch.prepare_requests(model.dcfg, _prompts(n), model.max_len,
                                  model._cache_slack(),
                                  batch.text_prompt(model.tparams, CPU), CPU)
    states = batch.batched_prefill(model.tparams, model.dparams, model.tcfg, model.dcfg,
                                   model.spec, sampling, reqs, model.max_len, 64,
                                   torch.float32, seed=3, mparams=model.mparams, device=CPU)
    return sampling, states


CAPS = np.array([40, 12, 40])


def _chunks(model, sampling, states, sizes, mesh=None, before=None):
    """Chunks of ``sizes`` rounds through ``batch._rounds_chunk`` (the
    rounds themselves unsharded: ``mesh`` only reaches the choice of
    path), each state appended to ``before`` as its chunk starts; the
    counters of every round."""
    def one(state, eos, caps):
        if model.mparams is not None:
            return spec_loop.medusa_decode_round(model.tparams, model.mparams, model.tcfg,
                                                 model.spec, sampling, state, eos, caps)
        return spec_loop.decode_round(model.tparams, model.dparams, model.tcfg, model.dcfg,
                                      model.spec, sampling, state, eos, caps)

    counts = []
    for n in sizes:
        if before is not None:
            before.append(states)
        states, c = batch._rounds_chunk(one, states, NO_EOS, CAPS[:states.done.shape[0]],
                                        n, mesh, (model.tparams, model.dparams))
        counts.append(c)
    return states, torch.cat(counts)


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_cpu_tensors_and_a_mesh_stay_eager(text_model, where):
    """A default runner over CPU tensors, and a runner that would engage on
    the CPU but is handed a mesh, capture nothing; the rounds are the
    eager ``_rounds_chunk``'s bit for bit."""
    sampling, s0 = _states(text_model)
    ref, ref_counts = _chunks(text_model, sampling, s0, (2, 3))
    sampling, s1 = _states(text_model)
    if where == "cpu":
        graph, made, mesh = round_graph.RoundGraph(), [], None
    else:
        (graph, made), mesh = _stand_in(lambda: _leaves(s1)), object()
    with round_graph.replaying(graph):
        out, counts = _chunks(text_model, sampling, s1, (2, 3), mesh)
    assert not made and graph.captures == 0 and graph.replayed == 0
    assert torch.equal(counts, ref_counts)
    for a, b in zip(_leaves(out), _leaves(ref)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["greedy", "unit-batch", "sampled", "medusa"])
def test_replays_give_the_eager_tokens(text_model, kind):
    """The first chunk runs eagerly, the next captures once and replays:
    every round's counters and every leaf of the state equal the eager
    rounds' (greedy at B = 3 and B = 1, drawn at T = 1 from the slots'
    keys, Medusa)."""
    model = _model(medusa=True) if kind == "medusa" else text_model
    n, sampled = (1 if kind == "unit-batch" else 3), kind == "sampled"
    sampling, s0 = _states(model, n, sampled)
    ref, ref_counts = _chunks(model, sampling, s0, (2, 3, 1))
    sampling, s1 = _states(model, n, sampled)
    before = []
    graph, made = _stand_in(lambda: _leaves(before[-1]))
    with round_graph.replaying(graph):
        out, counts = _chunks(model, sampling, s1, (2, 3, 1), before=before)
    assert graph.captures == 1 and len(made) == 1 and graph.replayed == 4
    assert torch.equal(counts, ref_counts)
    for a, b in zip(_leaves(out), _leaves(ref)):
        assert torch.equal(a, b)
    # the state the replays return is the one captured: the same buffers
    assert [t.data_ptr() for t in _leaves(out)] == [t.data_ptr() for t in _leaves(before[1])]


def test_a_replay_adds_the_captured_launches_to_every_counter(text_model):
    """Each replay adds the launches the capture counted, for each wrapper
    counter; the capture itself adds nothing."""
    sampling, states = _states(text_model)
    keys = list(round_graph.launch_counts())
    assert len(keys) == 5  # 1a and 1c over bf16/f32 and int8 caches, kernel 2

    def fake_round(state, eos, caps):  # counts launches as a round of kernels would
        for i, (f, a) in enumerate(keys):
            setattr(f, a, getattr(f, a) + i + 1)
        return state._replace(new_token=state.new_token + 1)

    before = []
    graph, _ = _stand_in(lambda: _leaves(before[-1]))
    start = round_graph.launch_counts()
    with round_graph.replaying(graph):
        for n in (2, 3, 4):  # eager, then a capture and 3 replays, then 4
            before.append(states)
            states, counts = batch._rounds_chunk(fake_round, states, NO_EOS, CAPS, n)
    end = round_graph.launch_counts()
    assert graph.launches == {k: i + 1 for i, k in enumerate(keys)}
    assert {k: end[k] - start[k] for k in keys} == {k: (2 + 3 + 4) * (i + 1)
                                                    for i, k in enumerate(keys)}
    assert counts[:, 0].tolist() == [6, 7, 8, 9]


def _engine(model, stand_in: bool):
    eng = ServingEngine(model, batch_size=2, max_new_tokens=8, chunk_rounds=2,
                        temperature=1.0, per_request_sampling=True, top_k=8, seed=7)
    if stand_in:
        eng._graph = _stand_in(lambda: _leaves(eng._states))[0]
    return eng


def _session(eng, seed):
    reqs = [{"input_ids": p, "temperature": t, "top_k": 4 * (i % 2)}
            for i, (p, t) in enumerate(zip(_prompts(3, seed), (0.0, 1.0, 0.7)))]
    return [o.tolist() for o in eng.run_all(reqs)]


def test_an_engine_captures_once_across_sessions_and_again_when_buffers_move(text_model):
    """Per-request sampling (keys, knobs and seen masks in the state): the
    stand-in engine's outputs equal the eager engine's in each of three
    sessions; the first session's second chunk captures, the next session
    replays that capture, and a state whose buffers moved is captured
    again."""
    eager, graphed = _engine(text_model, False), _engine(text_model, True)
    assert _session(graphed, 1) == _session(eager, 1)
    g = graphed._graph
    assert g.captures == 1 and graphed.stats["graph_rounds"] == g.replayed > 0
    assert graphed.stats["rounds"] == eager.stats["rounds"]
    assert _session(graphed, 2) == _session(eager, 2)
    assert g.captures == 1 and graphed.stats["graph_rounds"] == graphed.stats["rounds"]
    graphed._states = spec_loop.map_states(torch.clone, graphed._states)
    assert _session(graphed, 3) == _session(eager, 3)
    assert g.captures == 2


def test_each_replayed_round_opens_a_replay_span_inside_its_round(text_model):
    eng = _engine(text_model, True)
    _session(eng, 1)  # warm and capture outside the session
    with profile(activities=[ProfilerActivity.CPU]):
        _session(eng, 2)
    spans = profiling.SPANS.records()
    rounds = [i for i, s in enumerate(spans) if s.name == "engine.round"]
    replays = [s for s in spans if s.name == "round.replay"]
    assert len(rounds) == eng.stats["rounds"] == len(replays) > 0
    assert sorted(s.parent for s in replays) == rounds
