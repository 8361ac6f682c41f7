"""Greedy speculative decoding: a draft proposes, the target verifies.

Port of ``ray_tpu/models/speculative.py``. A small DRAFT model proposes
``k`` tokens one at a time; the TARGET model scores all ``k+1`` positions
in ONE forward and commits the longest matching prefix plus its own next
token. With greedy acceptance the output is the target's own greedy
decode (``decoding.generate`` at temperature 0), for any draft: a bad
draft costs speed, never tokens.

JAX runs the whole loop as one ``lax.while_loop`` program; the port runs
it on the host and reads the device once per round, for the loop's
condition. Everything else stays on the device and keeps JAX's static
shapes:

- both KV caches advance by fixed-size chunk writes at per-row offsets
  (``decoding.cached_forward`` writes the caches in place; stale entries
  past the accepted length are overwritten next round);
- the draft's ``k`` proposals are ``k`` one-token cached forwards (JAX's
  ``lax.scan``);
- after verification the committed chunk is fed to the draft again in
  one (k+1)-token forward, which repairs its cache to the committed
  prefix and appends the entry a fully accepted round needs;
- per-row acceptance counts, EOS stops and output writes are masks, in
  JAX's order: the per-row acceptance mask, then EOS, then pad.

``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does. The
jit-compiled ``speculative_generate_jit`` has no counterpart.

On the card the target's verify forward multiplies ``b (k+1)`` rows where
its decode step multiplies ``b``; the library's GEMMs may sum those in
other orders, so in bf16 a greedy token at a near-tie can differ from the
decode's through no fault of the drafting (``chip_smoke.py`` holds the
logits there).
"""

from __future__ import annotations

import torch

from ray_tpu_torch.models.decoding import cached_forward, init_cache


def _prompt_lengths(prompts, pad_id):
    p = prompts.shape[1]
    positions = torch.arange(p, dtype=torch.int32,
                             device=prompts.device)[None, :]
    lens = torch.where(prompts != pad_id, positions + 1, 0).amax(dim=1)
    return lens.clamp(min=1).to(torch.int32)


def _argmax(logits):
    return logits.argmax(dim=-1).to(torch.int32)


@torch.inference_mode()
def speculative_generate(cfg_t, params_t, cfg_d, params_d, prompts, *,
                         k_spec: int = 4, max_new_tokens: int = 128,
                         eos_id: int | None = None, pad_id: int = 0,
                         return_stats: bool = False):
    """Greedy decode of the TARGET model, accelerated by a draft.

    prompts [B, P] right-padded with ``pad_id``, on the device both models
    live on. Returns tokens [B, max_new_tokens] (``pad_id`` after EOS),
    plus ``{"rounds": int, "accepted": [B]}`` when ``return_stats``.
    Guarantee: identical to ``decoding.generate`` with
    ``SamplingParams(temperature=0, max_new_tokens=...)`` on the target.
    """
    dev = prompts.device
    b, p = prompts.shape
    k = k_spec
    prompt_lens = _prompt_lengths(prompts, pad_id)
    max_total = p + max_new_tokens + k + 2

    cache_t = init_cache(cfg_t, b, max_total, device=dev)
    cache_d = init_cache(cfg_d, b, max_total, device=dev)

    # prefill both models; the target's logits at each row's last prompt
    # position give the first pending token (as decoding.generate does)
    zeros = torch.zeros((b,), dtype=torch.int32, device=dev)
    logits_t, _ = cached_forward(cfg_t, params_t, prompts, cache_t,
                                 start=zeros, logits_mode="index",
                                 logits_idx=prompt_lens - 1)
    cached_forward(cfg_d, params_d, prompts, cache_d, start=zeros,
                   logits_mode="last")
    t0 = _argmax(logits_t)

    # invariant: cache length m = committed-token count - 1, and t0 is the
    # one committed token not yet fed
    m = prompt_lens
    width = max_new_tokens + k + 1
    out = torch.full((b, width), pad_id, dtype=torch.int32, device=dev)
    done = (t0 == eos_id) if eos_id is not None else \
        torch.zeros((b,), dtype=torch.bool, device=dev)
    out[:, 0] = t0          # the pending first token is emitted at once
    o = torch.ones((b,), dtype=torch.int32, device=dev)
    rounds = 0
    acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    idx = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(b, device=dev)[:, None]

    while bool((~done & (o < max_new_tokens)).any()):   # one read a round
        # -- the draft proposes k tokens, one at a time ------------------
        tok, proposals = t0, []
        for j in range(k):
            logits, _ = cached_forward(cfg_d, params_d, tok[:, None],
                                       cache_d, start=m + j,
                                       logits_mode="last")
            tok = _argmax(logits)
            proposals.append(tok)
        d = torch.stack(proposals, dim=1)                   # [B, k]

        # -- the target verifies the whole chunk in one forward ----------
        chunk = torch.cat([t0[:, None], d], dim=1)          # [B, k+1]
        logits_t, _ = cached_forward(cfg_t, params_t, chunk, cache_t,
                                     start=m, logits_mode="all")
        g = _argmax(logits_t)                               # [B, k+1]

        # accepted prefix length n = leading i with d[:, i] == g[:, i]
        match = (d == g[:, :k]).to(torch.int32)
        n = match.cumprod(dim=1).sum(dim=1, dtype=torch.int32)
        # committed this round: d1..dn, then the target's own token
        t0_new = g.gather(1, n[:, None].long())[:, 0]
        # the emitted chunk [B, k+1]: positions < n the accepted proposals,
        # == n the target's token at the first mismatch (or the bonus)
        cand = torch.where(idx < n[:, None],
                           torch.nn.functional.pad(d, (0, 1)), 0)
        cand = torch.where(idx == n[:, None], t0_new[:, None], cand)

        advance = n + 1
        if eos_id is not None:
            is_eos = (cand == eos_id) & (idx <= n[:, None])
            newly_done = is_eos.any(dim=1)
            eos_pos = torch.where(newly_done,
                                  is_eos.to(torch.int32).argmax(dim=1),
                                  k + 1).to(torch.int32)
            advance = torch.minimum(advance, eos_pos + 1)
        else:
            newly_done = torch.zeros((b,), dtype=torch.bool, device=dev)
        cand = torch.where(idx < advance[:, None], cand, pad_id)
        done_at_entry = done        # rows already finished BEFORE this round
        advance = torch.where(done_at_entry, 0, advance)
        cand = torch.where(done_at_entry[:, None], pad_id, cand)

        # -- the chunk into the output at per-row offsets (a window that
        # would run past the end shifts back, as dynamic_update_slice) ----
        start = o.long().clamp(0, width - (k + 1))
        out[rows, start[:, None] + idx.long()] = cand.to(torch.int32)
        o_new = torch.clamp(o + advance, max=width)
        done = done | newly_done | (o_new >= max_new_tokens)

        # -- repair/extend the draft cache with the committed chunk -------
        cached_forward(cfg_d, params_d, chunk, cache_d, start=m,
                       logits_mode="last")

        m = torch.where(advance > 0, m + advance, m)
        t0 = torch.where(advance > 0, t0_new, t0)
        # count acceptances for rows ACTIVE at round entry; masking with
        # the updated `done` would drop each row's final round
        acc = acc + torch.where(done_at_entry, 0, n)
        o = o_new
        rounds += 1

    tokens = out[:, :max_new_tokens]
    if return_stats:
        return tokens, {"rounds": rounds, "accepted": acc}
    return tokens
