"""dLLM transformer, dense or MoE: config, layers, MoE FFN, forward,
registry."""
