"""What decides ``correct``: the served tokens against the plain reference.

After the window has closed and the program is gone, a sample of the
finished requests, drawn from the seed with the longest one in it, is run
through the reference (float32, TF32 off; ``reference/<family>.py``) over
prompt + served tokens, and each served token is judged where it was
produced, at its committed prefix:

- temperature 0: the token must be the reference's argmax. ``greedy_gap``
  is the widest gap by which a served token's logit lies below the
  reference's best.
- temperature > 0: every committed token is typed from the chunk's stats
  rows (the draft tokens the verify accepted, the token that follows a
  rejection, a bonus after a full window, a fused round's sample). A token
  after a rejection is drawn from the residual max(p - q, 0), so the
  reference must put p above q there: ``residual_gap`` is the widest
  log q - log p over those tokens. Each accept/reject test at a committed
  prefix succeeds with probability sum_v min(p_v, q_v): ``accept_z`` is
  |sum (outcome - that probability)| over its binomial standard deviation.

Structural numbers hold every finished request and the stream: tokens in
the vocabulary, as many as the budget (no EOS is set), the stats rows
adding up to the tokens, and no request resident for more rounds than its
budget without finishing (a step that leaves its state unchanged, or
slots left out, show there).

The control (``--control 1``; never in the benchmark's own runs) puts the
reference at the next precision below the served bfloat16 in the
program's place: every matrix product and the attention's inputs in
float8 e4m3 (``reference.common.fp8``). At temperature 0 it reads the gap
of the token it ranks first at each position; at temperature > 0 it draws
each post-rejection token from its own residual and each accept/reject
outcome from its own acceptance probability (seeded), and reads that
token's log q - log p and the outcomes' z. Its numbers take the compared
names, so the run's own comparison judges the control; the program's
readings stay beside them as ``program_<name>``."""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

LOGIT_ROWS = 2048


def token_types(rounds: list, n_tokens: int) -> list:
    """Per committed token: "anchor", "accept", "reject" (drawn after a
    rejection), "bonus" or "fused", from the rounds' (gamma, n_acc, new)."""
    types = ["anchor"]
    for gamma, na, new in rounds:
        if new <= 0:
            continue
        types += ["accept"] * min(na, new)
        if new > na:
            types.append("fused" if gamma == 0 else
                         "reject" if na < gamma else "bonus")
    return types[:n_tokens] if len(types) >= n_tokens else types


def sample(finished: list, k: int, seed: int) -> list:
    """The longest finished request and k - 1 others drawn from the seed."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-len(r.tokens), r.request_id))
    rest = order[1:]
    rng = np.random.default_rng(abs(int(seed)) + 1)
    pick = rng.permutation(len(rest))[:max(0, k - 1)]
    return [order[0]] + [rest[i] for i in sorted(pick)]


def _rows(h: torch.Tensor, seqs: list, prompts: list) -> torch.Tensor:
    """Hidden rows that predict each served token: in sequence i (prompt +
    tokens[:-1]) the rows prompt_len - 1 .. end."""
    out, off = [], 0
    for s, p in zip(seqs, prompts):
        out.append(h[off + p - 1:off + len(s)])
        off += len(s)
    return torch.cat(out)


def judge(cfg: dict, draw, picked: list, prompts_by_id: dict,
          temperature: float, seed: int, device, control: bool) -> dict:
    """The reference's numbers over ``picked`` finished requests.
    ``draw(side)`` returns that side's weights (drawn again from the
    seed)."""
    import weights as W
    from reference.common import head
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sides = ("target", "draft") if temperature > 0 else ("target",)
    seqs, prompts, toks, types = [], [], [], []
    for r in picked:
        p = prompts_by_id[r.request_id]
        t = np.asarray(r.tokens, np.int64)
        seqs.append(np.concatenate([p, t[:-1]]))
        prompts.append(len(p))
        toks.append(t)
        types += token_types(r.rounds, len(t))
    tok = torch.as_tensor(np.concatenate(toks), device=device)
    hid, ctl, params = {}, {}, {}
    for side in sides:
        s = W.sizes(cfg["port"][side])
        params[side] = (draw(side), s)
        mod = importlib.import_module(f"reference.{cfg['families'][side]}")
        with torch.no_grad():
            hid[side] = _rows(mod.hidden(params[side][0], s, seqs), seqs,
                              prompts)
            if control:
                ctl[side] = _rows(mod.hidden(params[side][0], s, seqs,
                                             q8=True), seqs, prompts)
    out = {"tokens_judged": int(tok.numel())}
    gen = torch.Generator(device=device)
    gen.manual_seed(abs(int(seed)) % 2**63)
    greedy, resid, ctrl = [], [], []
    z_sum = var = z8_sum = 0.0
    kind = np.array(types + ["?"] * (tok.numel() - len(types)))
    with torch.no_grad():
        for i in range(0, tok.numel(), LOGIT_ROWS):
            sl = slice(i, i + LOGIT_ROWS)
            y = tok[sl]
            zt = head(params["target"][0], params["target"][1],
                      hid["target"][sl])
            if temperature <= 0:
                best = zt.max(-1).values
                greedy.append((best - zt.gather(1, y[:, None])[:, 0]).max())
                if control:
                    z8 = head(params["target"][0], params["target"][1],
                              ctl["target"][sl], q8=True)
                    x8 = z8.argmax(-1)
                    ctrl.append((best - zt.gather(1, x8[:, None])[:, 0]).max())
                continue
            zd = head(params["draft"][0], params["draft"][1], hid["draft"][sl])
            lp = torch.log_softmax(zt / temperature, -1)
            lq = torch.log_softmax(zd / temperature, -1)
            k = kind[sl]
            rej = torch.as_tensor(k == "reject", device=device)
            acc = torch.as_tensor(k == "accept", device=device)
            gap = (lq - lp).gather(1, y[:, None])[:, 0]
            if rej.any():
                resid.append(gap[rej].max())
            tested = rej | acc
            if tested.any():
                a = torch.exp(torch.minimum(lp[tested], lq[tested])).sum(-1)
                x = acc[tested].double()
                z_sum += float((x - a.double()).sum())
                var += float((a.double() * (1 - a.double())).sum())
            if control and tested.any():
                pt8 = torch.softmax(head(params["target"][0],
                                         params["target"][1],
                                         ctl["target"][sl][tested], q8=True)
                                    / temperature, -1)
                pd8 = torch.softmax(head(params["draft"][0],
                                         params["draft"][1],
                                         ctl["draft"][sl][tested], q8=True)
                                    / temperature, -1)
                a8 = torch.minimum(pt8, pd8).sum(-1)
                x8 = torch.bernoulli(a8.clamp(0, 1), generator=gen).double()
                z8_sum += float((x8 - a.double()).sum())
                r = rej[tested]
                if r.any():
                    y8 = torch.multinomial((pt8[r] - pd8[r]).clamp_min(0), 1,
                                           generator=gen)
                    ctrl.append((lq[rej] - lp[rej]).gather(1, y8)[:, 0].max())
                del pt8, pd8
    if temperature <= 0:
        out["greedy_gap"] = float(torch.stack(greedy).max())
        ctl_out = {"greedy_gap": float(torch.stack(ctrl).max())
                   if ctrl else None}
    else:
        out["residual_gap"] = (float(torch.stack(resid).max()) if resid
                               else None)
        out["accept_z"] = abs(z_sum) / math.sqrt(var) if var > 0 else None
        out["tests"] = int((kind == "accept").sum() + (kind == "reject").sum())
        out["rejects"] = int((kind == "reject").sum())
        ctl_out = {"residual_gap": float(torch.stack(ctrl).max())
                   if ctrl else None,
                   "accept_z": abs(z8_sum) / math.sqrt(var) if var > 0
                   else None}
    if control:
        for k, v in ctl_out.items():
            out["program_" + k], out[k] = out[k], v
    return out


def structure(reqs: list, vocab: int) -> dict:
    """Counts of finished requests whose tokens are out of the vocabulary,
    not as many as their budget, or not what the stats rows add up to;
    and of requests resident longer than their budget in rounds without
    finishing."""
    bad_range = bad_len = bad_rows = overdue = 0
    finished = 0
    for r in reqs:
        if r.tokens is not None:
            finished += 1
            t = np.asarray(r.tokens)
            bad_range += int(((t < 0) | (t >= vocab)).any())
            bad_len += int(len(t) != r.budget)
            bad_rows += int(1 + sum(n for _, _, n in r.rounds) != len(t))
        elif r.first is not None and r.rounds_resident > r.budget:
            overdue += 1
    return {"finished": finished, "out_of_vocab": bad_range,
            "wrong_length": bad_len, "rows_disagree": bad_rows,
            "overdue": overdue}
