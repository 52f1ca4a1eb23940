"""The yardstick's arithmetic: model FLOPs, attention and B5 bytes, and the
H100's peaks. It counts the work that the inputs need, whatever the
program does to get it done, from the sizes of ``weights.sizes``.

Peaks (one place): NVIDIA H100 SXM data sheet, dense bf16 989 TFLOP/s and
HBM3 3.35 TB/s, at the 700 W limit; ``nvidia-smi``'s power.limit is
printed beside every run.

- Matmul FLOPs per token: 2 x the matrix parameters a token passes through
  (every layer's projections and MLP, a hybrid's shared block once per
  call, the lm head; not the embedding gather).
- Attention FLOPs per token at context n (n positions attended): 4 n H hd
  per attention layer (q.k and p.v, 2 FLOPs per multiply-add).
- SSD FLOPs per token per Mamba2 layer: 4 d_inner N (the state update
  dt x (x) B and the read-out C . h, 2 FLOPs per multiply-add) plus
  2 K conv_dim for the depthwise conv.
- A round of speculation: the target's (gamma_r + 1) tokens and the
  draft's gamma_r tokens per active slot, gamma_r the policy's gamma for
  that round (0: a fused round, one target token). A prefill: the prompt's
  own tokens on both sides, not the pad bound.
- Attention (B1/B2) bytes of one launch: each valid cached position's K
  and V once, plus the queries and the output. A slot's valid positions
  are its cached length at the chunk's start; the launches an active slot
  needs in a round are the draft's gamma_r steps per draft attention
  layer and the target's verify per attention layer (a hybrid's also the
  re-advance over the committed tokens), not the gamma_max the masked
  step runs.
- B5 bytes of one launch: x, B, C, dt read once, y written once, the state
  read and written once (float32), over the active slots' gamma_r + 1
  verify tokens and each prompt's own tokens; FLOPs: the chunked form's three
  products per chunk of length Q: 2 Q^2 N (C.B^T) + 2 Q^2 nh hd (the
  masked form times x) + 4 Q nh hd N (chunk state and its read-out)."""

from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_BYTES = 3.35e12         # HBM3
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def attn_matmul_params(s: dict) -> int:
    d, H, Hkv, hd = s["d"], s["H"], s["Hkv"], s["hd"]
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def matmul_params(s: dict) -> int:
    """Matrix parameters one token passes through (lm head included)."""
    d, L = s["d"], s["L"]
    head = d * s["V"]
    if s["family"] in ("ssm", "hybrid"):
        per = d * (2 * s["din"] + 2 * s["N"] + s["nh"]) + s["din"] * d
        total = L * per
        if s["family"] == "hybrid":
            total += s["n_seg"] * (attn_matmul_params(s) + 3 * d * s["f"])
        return total + head
    return L * (attn_matmul_params(s) + 3 * d * s["f"]) + head


def attention_layers(s: dict) -> int:
    """Attention calls per token: every layer of a dense stack, one per
    segment of a hybrid, none for a Mamba2 stack."""
    if s["family"] == "hybrid":
        return s["n_seg"]
    if s["family"] == "ssm":
        return 0
    return s["L"]


def token_flops(s: dict, context: float) -> float:
    """FLOPs of one token that attends ``context`` positions."""
    f = 2.0 * matmul_params(s)
    f += 4.0 * context * s["H"] * s["hd"] * attention_layers(s)
    if s["family"] in ("ssm", "hybrid"):
        f += s["L"] * (4.0 * s["din"] * s["N"] + 2.0 * s["K"] * s["conv"])
    return f


def prefill_flops(s: dict, n: int) -> float:
    """A prompt of n tokens, token i attending i + 1 positions."""
    return n * token_flops(s, 0.0) \
        + 4.0 * s["H"] * s["hd"] * attention_layers(s) * n * (n + 1) / 2


def round_flops(t: dict, d: dict, gamma: int, contexts) -> float:
    """One round over the active slots' cached lengths ``contexts``: the
    target's gamma + 1 tokens and the draft's gamma tokens per slot."""
    total = 0.0
    for n in contexts:
        total += (gamma + 1) * token_flops(t, n + gamma / 2.0)
        total += gamma * token_flops(d, n + (gamma - 1) / 2.0)
    return total


def kv_bytes_per_position(s: dict) -> int:
    """K and V of one cached position in one attention layer."""
    return 2 * s["Hkv"] * s["hd"] * ESIZE[s["dtype"]]


def attn_slot_round_cost(t: dict, d: dict, n: float, gamma: int,
                         new: int) -> tuple[float, float]:
    """(bytes, FLOPs) of the attention one active slot needs in one round:
    ``n`` cached positions, the round's gamma, ``new`` tokens committed.
    The draft's gamma steps through each of its attention layers (one
    query each); the target's verify through each attention layer with
    gamma + 1 queries, and for a hybrid also the re-advance over the
    ``new`` committed tokens through every segment's shared block (one
    query each). Each launch reads the n positions once."""
    launches = []                  # (side, launches, queries per launch)
    if attention_layers(d):
        launches.append((d, gamma * attention_layers(d), 1))
    if t["family"] == "hybrid":
        launches.append((t, t["n_seg"], gamma + 1))
        launches.append((t, t["n_seg"] * new, 1))
    elif attention_layers(t):
        launches.append((t, attention_layers(t), gamma + 1))
    nbytes = flops = 0.0
    for s, k, q in launches:
        e = ESIZE[s["dtype"]]
        nbytes += k * (n * kv_bytes_per_position(s)
                       + 2 * q * s["H"] * s["hd"] * e)
        flops += k * 4.0 * q * n * s["H"] * s["hd"]
    return nbytes, flops


def attn_prefill_cost(t: dict, d: dict, n: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one admission's attention at the prompt's own
    length n: each side's layers read n positions and carry n queries."""
    nbytes = flops = 0.0
    for s in (t, d):
        a = attention_layers(s)
        if not a:
            continue
        e = ESIZE[s["dtype"]]
        nbytes += a * (n * kv_bytes_per_position(s)
                       + 2 * n * s["H"] * s["hd"] * e)
        flops += a * 4.0 * s["H"] * s["hd"] * n * (n + 1) / 2
    return nbytes, flops


def ssd_launch_cost(s: dict, B: int, S: int) -> tuple[float, float]:
    """(bytes, FLOPs) of one B5 launch over B sequences of S tokens."""
    nh, hd, N = s["nh"], s["P"], s["N"]
    e = ESIZE[s["dtype"]]
    Q = min(128, S)
    chunks = -(-S // Q)
    nbytes = B * (S * (2 * nh * hd + 2 * N) * e + S * nh * 4
                  + 2 * nh * hd * N * 4)
    flops = B * chunks * (2.0 * Q * Q * N + 2.0 * Q * Q * nh * hd
                          + 4.0 * Q * nh * hd * N)
    return nbytes, flops


def ssd_slot_round_cost(t: dict, gamma: int) -> tuple[float, float]:
    """B5 that one active slot needs in one round: its verify window of
    gamma + 1 tokens through every target Mamba2 layer."""
    if t["family"] not in ("ssm", "hybrid"):
        return 0.0, 0.0
    b, f = ssd_launch_cost(t, 1, gamma + 1)
    return t["L"] * b, t["L"] * f


def ssd_prefill_cost(t: dict, d: dict, n: int) -> tuple[float, float]:
    """B5 in one admission: every Mamba2 layer of both sides over the
    prompt's own n tokens."""
    nbytes = flops = 0.0
    for s in (t, d):
        if s["family"] in ("ssm", "hybrid"):
            b, f = ssd_launch_cost(s, 1, n)
            nbytes += s["L"] * b
            flops += s["L"] * f
    return nbytes, flops


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)
