"""The decode round replayed as a CUDA graph (``spec/round_graph.py``) on
the card, at toy widths in float32: the same tokens as the eager round,
replays that never wait on the device, and torch.profiler's attention
launches equal to the wrappers' counts after replays.

Every test here needs an NVIDIA GPU with nvcc and skips elsewhere; the file
imports neither jax nor the JAX package."""

from unittest import mock

import numpy as np
import pytest
import torch

from vispec_tpu_torch import configs
from vispec_tpu_torch.models import draft as draft_mod
from vispec_tpu_torch.models import llama
from vispec_tpu_torch.models import medusa as medusa_mod
from vispec_tpu_torch.ops import verify_attention as va
from vispec_tpu_torch.spec import batch, round_graph
from vispec_tpu_torch.spec.spec_model import SpecModel

WIDTHS = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=512)
SPEC = configs.SpecConfig(total_tokens=12, depth=3, top_k=4)
NO_EOS = 10**6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dev, medusa=False):
    gen = torch.Generator(device=dev).manual_seed(0)
    tcfg = configs.LlamaConfig(num_hidden_layers=2, **WIDTHS)
    dcfg = configs.DraftConfig(num_q=2, **WIDTHS)
    tparams = llama.init_params(tcfg, gen, dev, torch.float32)
    dparams = draft_mod.init_params(dcfg, gen, dev, torch.float32)
    dparams["embed"] = tparams["embed"]
    kw = {}
    if medusa:
        heads = medusa_mod.init_params(WIDTHS["hidden_size"], dev, torch.float32)
        kw["mparams"] = {k: 0.05 * torch.randn(v.shape, generator=gen, device=dev)
                         for k, v in heads.items()}
    return SpecModel(tcfg, dcfg, SPEC, tparams, dparams, max_len=256, dtype=torch.float32,
                     device=dev, eos_token_id=NO_EOS, **kw)


def _requests(kind):
    rng = np.random.default_rng(5)
    prompts = [rng.integers(5, 200, rng.integers(8, 40)).tolist() for _ in range(5)]
    if kind == "sampled":
        return [{"input_ids": p, "temperature": 1.0} for p in prompts]
    return prompts


def _serve(model, kind, graph: bool):
    kw = dict(per_request_sampling=True, top_k=8) if kind == "sampled" else {}
    eng = model.serving_engine(batch_size=3, max_new_tokens=16, chunk_rounds=4, **kw)
    with mock.patch.object(round_graph.RoundGraph, "engages",
                           round_graph.RoundGraph.engages if graph else lambda *a: False):
        outs = [o.tolist() for o in eng.run_all(_requests(kind))]
    return outs, eng


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["greedy", "medusa", "sampled"])
def test_replayed_rounds_give_the_eager_tokens(cuda_device, kind):
    model = _model(cuda_device, medusa=kind == "medusa")
    eager, _ = _serve(model, kind, False)
    graphed, eng = _serve(model, kind, True)
    assert graphed == eager
    assert eng._graph.captures == 1
    assert 0 < eng.stats["graph_rounds"] < eng.stats["rounds"]


def _warm(model):
    """An engine whose round is captured, with three requests in its slots."""
    eng = model.serving_engine(batch_size=3, max_new_tokens=64, chunk_rounds=2)
    eng.start_session()
    for p in _requests("greedy")[:3]:
        eng.submit(p)
    eng.step()  # the eager chunk
    eng.step()  # the capture and its replays
    assert eng._graph.captures == 1
    return eng


def _chunk(model, eng, n):
    with torch.no_grad(), round_graph.replaying(eng._graph):
        return batch.batched_decode_rounds_chunk(
            model.tparams, model.dparams, model.tcfg, model.dcfg, model.spec, eng.sampling,
            eng._states, NO_EOS, eng._caps, n_rounds=n)


@pytest.mark.gpu
def test_replays_never_wait_on_the_device(cuda_device):
    model = _model(cuda_device)
    eng = _warm(model)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _chunk(model, eng, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert eng._graph.captures == 1


@pytest.mark.gpu
def test_the_profilers_attention_launches_equal_the_counters(cuda_device):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = _model(cuda_device)
    eng = _warm(model)
    before = va.verify_attention_batched.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _chunk(model, eng, 3)
        torch.cuda.synchronize()
    counted = va.verify_attention_batched.launches - before
    traced = sum(1 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA and "partial_kernel" in e.name())
    assert counted == 3 * eng._graph.launches[(va.verify_attention_batched, "launches")]
    assert traced == counted > 0
