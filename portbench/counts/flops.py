"""Model FLOPs of the work a window served: 2 FLOPs per multiply-add of
every weight a token meets, plus attention over the keys it sees.  The
sizes come from the reference module's ``shapes(conf)``; only useful work
counts: a prefill's LM head over its last position alone, a decode token
once however many rows the batch computed."""
from __future__ import annotations


def decode_token(sh: dict, ctx: int) -> float:
    """One decoded token that attends over ``ctx`` keys."""
    attn = 2 * sh["layers"] * sh["heads"] * (sh["qk_dim"] + sh["v_dim"]) * ctx
    return 2 * (sh["body_params"] + sh["head_params"]) + attn


def prefill(sh: dict, seq: int) -> float:
    """One prefill of ``seq`` tokens, causal, the next token's logits only."""
    pairs = seq * (seq + 1) // 2
    attn = 2 * sh["layers"] * sh["heads"] * (sh["qk_dim"] + sh["v_dim"]) * pairs
    return 2 * sh["body_params"] * seq + 2 * sh["head_params"] + attn
