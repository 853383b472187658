"""Each kernel's least work, counted from the op's inputs as a cell drives
them: FLOPs of the products and bytes that must cross HBM (each input byte
read once and each output byte written once).  Frozen copies of the port's
``analysis/cost.py`` formulas (``_decode_attention``, ``_flash_attention``,
``_visible_pairs``, ``_moe_gmm``) for bfloat16 tensors."""
from __future__ import annotations

BF16 = 2


def decode_attention(lengths, heads: int, kv_heads: int, hd: int, hdv: int):
    """One call over rows whose valid cache lengths are ``lengths``:
    (flops, bytes).  Reads q, the valid K/V rows, the lengths; writes out."""
    n_valid = int(sum(lengths))
    B = len(lengths)
    flops = 2 * (hd + hdv) * heads * n_valid
    nbytes = (B * heads * hd * BF16 + B * heads * hdv * BF16 + 4 * B
              + n_valid * kv_heads * (hd + hdv) * BF16)
    return flops, nbytes


def visible_pairs(sq: int, sk: int, causal: bool = True) -> int:
    """Keys each query row sees, summed over rows (rows at 0..sq-1)."""
    if not causal:
        return sq * sk
    return sum(min(p, sk - 1) + 1 for p in range(sq))


def flash_attention(batch: int, sq: int, sk: int, heads: int, kv_heads: int,
                    hd: int, hdv: int, causal: bool = True):
    """One causal call: (flops, bytes).  Reads q, k, v; writes out."""
    pairs = batch * visible_pairs(sq, sk, causal)
    flops = 2 * (hd + hdv) * heads * pairs
    nbytes = BF16 * batch * (sq * heads * hd + sk * kv_heads * (hd + hdv)
                             + sq * heads * hdv)
    return flops, nbytes


def moe_gmm(experts: int, rows: int, d_in: int, d_out: int):
    """One grouped product x [E, R, d_in] @ w [E, d_in, d_out]: (flops,
    bytes).  Reads x and w; writes out [E, R, d_out]."""
    flops = 2 * experts * rows * d_in * d_out
    nbytes = BF16 * experts * (rows * d_in + d_in * d_out + rows * d_out)
    return flops, nbytes


def moe_capacity(group: int, top_k: int, experts: int, factor: float) -> int:
    """Rows an expert takes per token group (the port's ``moe._capacity``)."""
    c = int(group * top_k / experts * factor)
    return max(top_k, min(group, (c + 3) // 4 * 4))


def moe_rows(tokens: int, group_size: int, top_k: int, experts: int,
             factor: float) -> int:
    """Rows of each expert's slice of x when ``tokens`` go through one MoE
    layer: groups of min(group_size, tokens), C rows per group."""
    g = min(group_size, tokens)
    return (tokens // g) * moe_capacity(g, top_k, experts, factor)
