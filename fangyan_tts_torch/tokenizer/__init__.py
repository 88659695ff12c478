from .tokenizer import (
    CV2_SPECIAL_TOKENS,
    CV3_SPECIAL_TOKENS,
    ByteFallbackTokenizer,
    QwenTTSTokenizer,
    get_qwen_tokenizer,
)
