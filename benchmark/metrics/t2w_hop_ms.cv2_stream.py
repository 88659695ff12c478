"""Device ms of one CosyVoice2 token2wav hop: the mean `t2w_hop` span (CUDA
events at the edges of CosyVoice2TTS.token2wav: the prefix's flow re-solve,
the vocoder and the audio's fetch; work that other threads queue on the
device in between counts too)."""

from benchmark.metrics.reduce import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx, "t2w_hop")
