"""Model families ported to PyTorch: GPT (with its MoE variant), the
Llama family (Llama, Mistral, Qwen2, Gemma, the Mixtral layout),
``dummy_gpt`` and LoRA over any of them."""
