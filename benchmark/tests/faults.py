"""Faults planted under the timed path, for the checks that must catch
them: each takes ``patch(module, name, value)`` (pytest's
``monkeypatch.setattr``, or ``setattr`` in a process of its own) and
breaks the program where it produces its answers.

  step_returns_state_unchanged   a chunk of decode rounds returns its state
  half_the_batch_left_out        the second half of the slots gets the
                                 first half's hidden states
  token_altered_where_produced   the third token of every answer altered
"""

from __future__ import annotations

import torch


def _fault_step_unchanged(patch):
    from vispec_tpu_torch.spec import batch

    def unchanged(tparams, dparams, tcfg, dcfg, spec, sampling, states, eos, caps,
                  n_rounds, mesh=None):
        b = states.done.shape[0]
        return states, torch.zeros((n_rounds, b), dtype=torch.int32)

    patch(batch, "batched_decode_rounds_chunk", unchanged)


def _fault_half_batch(patch):
    from vispec_tpu_torch.spec import loop

    real = loop.target_forward

    def half(tparams, tcfg, embeds, pos, cache, mask, region=None, *a, **kw):
        out = real(tparams, tcfg, embeds, pos, cache, mask, region, *a, **kw)
        hidden = out[0]
        if region is not None and hidden.dim() == 3 and hidden.shape[0] > 1:
            b = hidden.shape[0]
            hidden = hidden.clone()
            hidden[b // 2:] = hidden[:b - b // 2]  # the rest stands in for half
            out = (hidden, *out[1:])
        return out

    patch(loop, "target_forward", half)


def _fault_token_altered(patch):
    from vispec_tpu_torch.spec import batch

    real = batch.batched_decode_rounds_chunk

    def altered(*a, **kw):
        states, counts = real(*a, **kw)
        out = states.output.clone()
        out[:, 2] = (out[:, 2] + 1) % 200 + 3  # the third token of every answer
        return states._replace(output=out), counts

    patch(batch, "batched_decode_rounds_chunk", altered)


FAULTS = {"step_returns_state_unchanged": _fault_step_unchanged,
          "half_the_batch_left_out": _fault_half_batch,
          "token_altered_where_produced": _fault_token_altered}
