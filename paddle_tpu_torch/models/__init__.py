from .gpt import GPT3_1p3B, GPT_TINY, GPTConfig, GPTForCausalLM

__all__ = ["GPT3_1p3B", "GPT_TINY", "GPTConfig", "GPTForCausalLM"]
