from .tokenizer import (
    CV2_SPECIAL_TOKENS,
    CV3_SPECIAL_TOKENS,
    ByteFallbackTokenizer,
    QwenTTSTokenizer,
    WhisperStyleTokenizer,
    get_qwen_tokenizer,
    get_tokenizer,
)
