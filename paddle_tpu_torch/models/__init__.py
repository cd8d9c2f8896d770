from .gpt import (GPT3_1p3B, GPT_TINY, GPTConfig, GPTForCausalLM, GPTModel,
                  GPTMoEMLP, gpt_moe_tiny, gpt_tiny)

__all__ = ["GPT3_1p3B", "GPT_TINY", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "GPTMoEMLP", "gpt_moe_tiny", "gpt_tiny"]
