"""Minimal HTTP serving front end over the continuous-batching engine.

A standard-library demonstration of the engine's online API (submit / step /
results): HTTP handler threads enqueue requests as they arrive; one decode
thread steps the engine (chunks of rounds, one host read each) and wakes
the waiting handlers as their requests complete, so requests batch
together whenever more than one is in flight.

  python -m vispec_tpu_torch.examples.serve_http [--port 8123] [--batch 4] \
      [--device cuda] [--selftest]

  curl -s localhost:8123/generate -d '{"input_ids": [5, 6, 7], "max_new_tokens": 16}'
  -> {"request_id": 0, "output_ids": [...]}

A random-weight demo model; with real weights build it with
``SpecModel.from_pretrained`` and tokenize on the client, or put a
tokenizer in front of /generate.  ``--selftest`` starts the server on
127.0.0.1, fires concurrent requests at it, checks each against a
single-request ``specgenerate`` and exits.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch


def build_model(device, hidden=128):
    from ..configs import DraftConfig, LlamaConfig, SpecConfig
    from ..models import draft as draft_mod
    from ..models import llama
    from ..spec.spec_model import SpecModel

    # head_dim 16 (the attention kernel takes 16 and 128)
    tcfg = LlamaConfig(vocab_size=512, hidden_size=hidden, intermediate_size=hidden * 2,
                       num_hidden_layers=2, num_attention_heads=hidden // 16,
                       num_key_value_heads=hidden // 32, max_position_embeddings=512)
    dcfg = DraftConfig(vocab_size=512, hidden_size=hidden, intermediate_size=hidden * 2,
                       num_attention_heads=hidden // 16, num_key_value_heads=hidden // 32,
                       max_position_embeddings=512, num_q=2)
    dev = torch.device(device)
    tparams = llama.init_params(tcfg, torch.Generator(dev).manual_seed(0), dev, torch.float32)
    dparams = draft_mod.init_params(dcfg, torch.Generator(dev).manual_seed(1), dev,
                                    torch.float32)
    dparams["embed"] = tparams["embed"]
    return SpecModel(tcfg, dcfg, SpecConfig(total_tokens=12, depth=3, top_k=4), tparams,
                     dparams, max_len=512, dtype=torch.float32, eos_token_id=10**6,
                     device=dev)


class EngineLoop:
    """One decode thread around the engine's online API; handler threads call
    generate() and block until their request completes."""

    def __init__(self, engine):
        self.eng = engine
        self.eng.start_session()
        self.cv = threading.Condition()
        self.stop = False
        self.dead = ""  # non-empty once the decode thread hit a fatal error
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop:
            with self.cv:
                if not self.eng.pending():
                    self.cv.wait(timeout=0.05)
                    continue
            try:
                done = self.eng.step()
            except Exception as e:  # device/engine failure: per-request
                # errors never raise here (the engine records them), so this
                # is fatal — unblock every waiting handler instead of hanging
                # all clients on a silently dead thread
                with self.cv:
                    self.dead = f"{type(e).__name__}: {e}"
                    self.cv.notify_all()
                return
            if done:
                with self.cv:
                    self.cv.notify_all()

    def generate(self, request, max_new_tokens=None):
        """``request``: token list, or a dict with ``input_ids`` plus
        optional per-request sampling keys (temperature/top_p/
        repetition_penalty/top_k — engine must be per_request_sampling)."""
        with self.cv:
            rid = self.eng.submit(request, max_new_tokens=max_new_tokens)
            self.cv.notify_all()
            while rid not in self.eng.results:
                if self.dead:
                    raise RuntimeError(f"decode thread died: {self.dead}")
                self.cv.wait(timeout=1.0)
            err = self.eng.errors.get(rid)
            out = self.eng.pop_result(rid)  # release per-request state — a
            # long-lived server must not grow host memory per request served
        if err:
            raise ValueError(err)  # admission rejected this request (400)
        return rid, out

    def cancel(self, rid):
        with self.cv:
            ok = self.eng.cancel(rid)
            self.cv.notify_all()
        return ok

    def shutdown(self):
        self.stop = True
        self.thread.join(timeout=5)


def make_server(port, loop_):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path == "/cancel":
                try:
                    body = json.loads(
                        self.rfile.read(int(self.headers["Content-Length"])))
                    ok = loop_.cancel(int(body["request_id"]))
                except Exception as e:
                    self.send_error(400, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps({"canceled": ok}).encode())
                return
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                body = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"])))
                req = {"input_ids": list(map(int, body["input_ids"]))}
                for k in ("temperature", "top_p", "repetition_penalty"):
                    if k in body:  # per-request sampling (engine must be
                        req[k] = float(body[k])  # per_request_sampling)
                if "top_k" in body:  # a mask over the engine's static
                    req["top_k"] = int(body["top_k"])  # max-k sort bucket
                cap = body.get("max_new_tokens")
            except Exception as e:  # malformed request
                self.send_error(400, str(e))
                return
            try:
                rid, out = loop_.generate(req, max_new_tokens=cap)
            except ValueError as e:  # admission rejected (e.g. prompt too
                self.send_error(400, str(e))  # long for every pad bucket)
                return
            except RuntimeError as e:  # decode thread is gone
                self.send_error(503, str(e))
                return
            resp = json.dumps({"request_id": rid,
                               "output_ids": np.asarray(out).tolist()})
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(resp.encode())

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=8123)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--max-new-tokens", type=int, default=24)
    p.add_argument("--per-request-sampling", action="store_true",
                   help="per-slot sampling: each request may carry its "
                        "own temperature/top_p/repetition_penalty/top_k "
                        "(top_k masks the engine's static max-k bucket; set "
                        "to 1 here so the selftest's sampled requests are "
                        "deterministic)")
    p.add_argument("--selftest", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False

    model = build_model(args.device)
    kw = {}
    if args.per_request_sampling:
        kw = dict(per_request_sampling=True, top_k=1)
    eng = model.serving_engine(batch_size=args.batch,
                               max_new_tokens=args.max_new_tokens, **kw)
    # a warm-up request before accepting traffic
    eng.run_all([[7, 8, 9]])
    loop_ = EngineLoop(eng)
    srv = make_server(args.port, loop_)
    print(f"serving on :{args.port} (batch={args.batch})", flush=True)

    if not args.selftest:
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            loop_.shutdown()
        return

    # ---- selftest: concurrent clients vs single-request specgenerate ----
    import urllib.request

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(5, 500, rng.integers(8, 20)).tolist()
               for _ in range(6)]
    singles = [model.specgenerate(p, max_new_tokens=args.max_new_tokens)
               .sequences.tolist() for p in prompts]

    results = {}

    def client(i):
        body = {"input_ids": prompts[i]}
        if i == 0:  # exercise the per-request token budget
            body["max_new_tokens"] = 8
        if args.per_request_sampling and i in (1, 2):
            # mixed batch: sampled requests next to greedy ones in the SAME
            # engine; engine top_k=1 makes T=1 deterministic (== greedy), so
            # the specgenerate comparison below still applies
            body["temperature"] = 1.0
            if i == 2:
                body["repetition_penalty"] = 1.0
        req = urllib.request.Request(
            f"http://127.0.0.1:{args.port}/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            results[i] = json.loads(r.read())["output_ids"]

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
        time.sleep(0.02)  # staggered arrivals — exercises mid-flight admission
    for t in threads:
        t.join()
    wall = time.time() - t0

    ok = 0
    for i, p in enumerate(prompts):
        out = results[i]
        ref = singles[i][len(p):len(p) + len(out)]
        assert ref == out[:len(ref)], (i, out, ref)
        ok += 1
    assert len(results[0]) <= 8, results[0]  # per-request cap honored

    # an over-long prompt must come back as HTTP 400 (admission rejects the
    # request; the engine and every other client stay alive)
    import urllib.error

    bad = urllib.request.Request(
        f"http://127.0.0.1:{args.port}/generate",
        data=json.dumps({"input_ids": list(range(5, 400))}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        urllib.request.urlopen(bad, timeout=60)
        raise AssertionError("over-long prompt was not rejected")
    except urllib.error.HTTPError as e:
        assert e.code == 400, e.code
    srv.shutdown()
    loop_.shutdown()
    print(f"selftest: {ok}/{len(prompts)} concurrent HTTP requests match "
          f"specgenerate ({wall:.1f}s, admissions="
          f"{eng.stats['admissions']})")
    print("serve_http demo OK")


if __name__ == "__main__":
    main()
