"""The yardstick's arithmetic: the H100's published peaks, the least time a
launch needs, each kernel's bytes and operations, and the model FLOPs of
completed work. Later changes to the system under test do not move these.

Peaks are NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
A kernel's bytes count each input read once and each output written once;
its operations count only the (query, key) pairs the mask leaves open, as
each row's own length and the chunk-causal rule give them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # float32 outside the tensor cores


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least ms a bf16 launch needs, and which peak bounds it."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def bound_f32(nbytes: float, flops: float) -> tuple[float, str]:
    """bound() for a float32 route, whose products run on the CUDA cores."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def decode_attention_work(b: int, s: int, qh: int, kv: int, hd: int, open_slots: int) -> tuple[float, float]:
    """(bytes, operations) of one bf16 decode-attention launch over B rows and
    an S-slot cache, `open_slots` the slots the rows' masks leave open,
    summed over the rows: q and the output, the new K / V rows read and
    written, K and V of the open slots, the float32 bias and the int32 write
    slots; two products per (query head, open slot)."""
    nbytes = 2 * (b * qh * hd) * 2 + 2 * (b * kv * hd) * 2 * 2 + 2 * (open_slots * kv * hd) * 2 + b * s * 4 + b * 4
    return float(nbytes), float(2 * 2 * qh * hd * open_slots)


def flash_attention_pairs(mel_len: list[int], l: int, chunk: int) -> int:
    """(query, key) pairs per head that the length mask and, with chunk > 0,
    the chunk-causal rule leave open, over rows of L positions."""
    total = 0
    for m in mel_len:
        m = min(int(m), l)
        if not chunk:
            total += l * m
            continue
        for q in range(l):  # a query sees the keys before the end of its chunk, below the row's length
            total += min((q // chunk + 1) * chunk, m)
    return total


def flash_attention_work(mel_len: list[int], l: int, h: int, d: int, chunk: int) -> tuple[float, float]:
    """(bytes, operations) of one bf16 flash-attention launch on (B, H, L, D)
    with B = len(mel_len): q and the output over every row, K and V below
    each row's length, the int32 lengths; two products a head and pair."""
    b = len(mel_len)
    nbytes = 2 * b * h * l * d * 2 + sum(min(int(m), l) for m in mel_len) * h * d * 2 * 2 + b * 4
    return float(nbytes), float(4 * d * h * flash_attention_pairs(mel_len, l, chunk))


def int4_matmul_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(bytes, operations) of one bf16 int4 matmul (M, K) x (K, N): x read,
    the packed weight (half a byte each), the float32 per-channel scales,
    the bf16 output written; 2 M K N operations."""
    nbytes = m * k * 2 + k * n // 2 + n * 4 + m * n * 2
    return float(nbytes), float(2 * m * k * n)


# ---- model FLOPs of completed work ------------------------------------------

def qwen_token_flops(c: dict) -> float:
    """Dense FLOPs of one token through the Qwen2 decoder and the speech head
    (2 x the weights it multiplies; the embedding tables are lookups)."""
    h, i, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    qh, kv = c["num_attention_heads"], c["num_key_value_heads"]
    layer = h * (qh + 2 * kv) * hd + qh * hd * h + 3 * h * i
    return 2.0 * (c["num_hidden_layers"] * layer + c["llm_output_size"] * (c["speech_token_size"] + c["extra_tokens"]))


def qwen_attention_flops(c: dict, keys_seen: int) -> float:
    """Attention FLOPs of queries that see `keys_seen` keys in all: QK^T and
    PV, every layer and query head."""
    return 4.0 * c["num_hidden_layers"] * c["num_attention_heads"] * c["head_dim"] * keys_seen


def lm_sequence_flops(c: dict, prompt_len: int, new_tokens: int) -> float:
    """A row's prefill of `prompt_len` tokens and `new_tokens` decode steps,
    each position attending every position up to itself."""
    n = prompt_len + new_tokens
    return qwen_token_flops(c) * n + qwen_attention_flops(c, n * (n + 1) // 2)


def dit_frame_flops(d: dict) -> float:
    """Dense FLOPs of one frame through the DiT: the input projection, the
    two grouped position convolutions, each block's q/k/v, output and MLP
    products, and the output projection (the AdaLN modulations are per
    utterance, not per frame)."""
    dim, inner = d["dim"], d["heads"] * d["dim_head"]
    block = dim * 3 * inner + inner * dim + 2 * dim * dim * d["ff_mult"]
    conv = 2 * dim * (dim // d["conv_pos_groups"]) * d["conv_pos_kernel"]
    return 2.0 * ((d["mel_dim"] * 2 + d["mu_dim"] + d["spk_dim"]) * dim + conv + d["depth"] * block + dim * d["mel_dim"])


def dit_solve_flops(f: dict, mel_len: int, chunk: int = 0) -> float:
    """One utterance's Euler solve: n_timesteps DiT calls on the CFG pair
    (two rows), the attention over the pairs the mask leaves open."""
    d = f["dit"]
    pairs = flash_attention_pairs([mel_len], mel_len, chunk)
    per_call = dit_frame_flops(d) * mel_len + 4.0 * d["depth"] * d["heads"] * d["dim_head"] * pairs
    return f["n_timesteps"] * 2 * per_call


def causal_hift_frame_flops(h: dict) -> float:
    """Convolution FLOPs of one mel frame through the causal HiFT: the f0
    predictor, conv_pre, each stage's upsampling convolution, source
    convolution, source and main residual blocks, and conv_post, at the
    sample rate each runs at (the source's STFT and the iSTFT are small)."""
    rates = list(h["upsample_rates"])
    nfft2 = h["istft_n_fft"] + 2
    ch0, fc = h["base_channels"], h["f0_cond_channels"]
    flops = 2 * (h["in_channels"] * fc * 4 + 4 * fc * fc * 3 + fc)
    flops += 2 * h["in_channels"] * ch0 * (h["conv_pre_look_right"] + 1)
    rate = 1
    down = []
    acc = 1
    for u in [1] + rates[::-1][:-1]:
        acc *= u
        down.append(acc)
    down = down[::-1]
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        ch_in, ch = ch0 // 2**i, ch0 // 2 ** (i + 1)
        rate *= u
        flops += 2 * rate * ch_in * ch * k
        du = down[i]
        flops += 2 * rate * nfft2 * ch * (1 if du == 1 else 2 * du)
        sk = h["source_resblock_kernel_sizes"][i]
        flops += 2 * rate * len(h["source_resblock_dilation_sizes"][i]) * 2 * ch * ch * sk
        for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            flops += 2 * rate * len(rd) * 2 * ch * ch * rk
    flops += 2 * rate * (ch0 // 2 ** len(rates)) * nfft2 * 7
    return float(flops)


def conformer_layer_flops(d: int, ffn: int, t: int, keys_seen: int) -> float:
    """One relative-attention encoder layer over T positions: q, k, v and
    output projections and the feed-forward per position, the projection of
    the 2T - 1 relative positions, and per (query, key) pair the content and
    position scores and the weighted values."""
    return 2.0 * (t * (4 * d * d + 2 * d * ffn) + (2 * t - 1) * d * d + 3 * d * keys_seen)


def upsample_encoder_flops(f: dict, n_tokens: int, chunk: int = 0) -> float:
    """The CosyVoice2 flow encoder over n tokens: the embedding, the
    pre-lookahead convolutions, the token layers, the x2 upsampling
    convolution and second embedding, and the frame layers, each attending
    the pairs the mask leaves open."""
    d, ffn, la = f["input_size"], f["enc_ffn"], f["pre_lookahead_len"]
    t, t2 = n_tokens, 2 * n_tokens
    flops = 2.0 * t * (d * d + d * d * (la + 1) + d * d * 3)
    flops += f["enc_blocks"] * conformer_layer_flops(d, ffn, t, flash_attention_pairs([t], t, chunk))
    flops += 2.0 * t2 * (d * d * 5 + d * d)
    flops += f["enc_up_blocks"] * conformer_layer_flops(d, ffn, t2, flash_attention_pairs([t2], t2, 2 * chunk))
    return flops + 2.0 * t2 * d * f["output_size"]


def unet_frame_flops(f: dict) -> float:
    """Dense FLOPs of one frame through the one-level causal U-Net: the down,
    mid and up levels (a ResNet block of two k3 convolutions and a k1
    residual, then Transformer blocks of q/k/v/out and a 4x feed-forward),
    the down and up k3 convolutions, the final block and projection."""
    (ch,) = f["decoder_channels"]
    inner = f["num_heads"] * f["attention_head_dim"]
    tb = 3 * ch * inner + inner * ch + 2 * ch * 4 * ch

    def level(cin: int) -> int:
        return cin * ch * 3 + ch * ch * 3 + cin * ch + f["n_blocks"] * tb

    levels = level(f["in_channels"]) + f["num_mid_blocks"] * level(ch) + level(2 * ch)
    return 2.0 * (levels + 2 * ch * ch * 3 + ch * ch * 3 + ch * f["output_size"])


def unet_solve_flops(f: dict, mel_len: int, chunk: int = 0) -> float:
    """One utterance's Euler solve through the U-Net on the CFG pair, the
    Transformer blocks attending the pairs the mask leaves open."""
    blocks = f["n_blocks"] * (2 + f["num_mid_blocks"])
    pairs = flash_attention_pairs([mel_len], mel_len, chunk)
    per_call = unet_frame_flops(f) * mel_len + 4.0 * blocks * f["num_heads"] * f["attention_head_dim"] * pairs
    return f["n_timesteps"] * 2 * per_call


def hift_frame_flops(h: dict) -> float:
    """Convolution FLOPs of one mel frame through the non-causal HiFT: the
    f0 predictor's five k3 convolutions, the k7 conv_pre, each stage's
    transposed upsampling (2 Cin Cout K / u an output frame), source
    convolution and residual blocks, and conv_post."""
    rates = list(h["upsample_rates"])
    nfft2 = h["istft_n_fft"] + 2
    ch0, fc = h["base_channels"], h["f0_cond_channels"]
    flops = 2 * (h["in_channels"] * fc * 3 + 4 * fc * fc * 3 + fc) + 2 * h["in_channels"] * ch0 * 7
    down, acc = [], 1
    for u in [1] + rates[::-1][:-1]:
        acc *= u
        down.append(acc)
    down = down[::-1]
    rate = 1
    for i, (u, k) in enumerate(zip(rates, h["upsample_kernel_sizes"])):
        ch_in, ch = ch0 // 2**i, ch0 // 2 ** (i + 1)
        rate *= u
        flops += 2 * rate * ch_in * ch * k // u
        flops += 2 * rate * nfft2 * ch * (1 if down[i] == 1 else 2 * down[i])
        flops += 2 * rate * len(h["source_resblock_dilation_sizes"][i]) * 2 * ch * ch * h["source_resblock_kernel_sizes"][i]
        for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            flops += 2 * rate * len(rd) * 2 * ch * ch * rk
    return float(flops + 2 * rate * (ch0 // 2 ** len(rates)) * nfft2 * 7)
