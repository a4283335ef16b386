"""Flash-decoding attention: one GQA query token against a KV cache."""
