"""Dense dLLM transformer: config, layers, forward, registry."""
