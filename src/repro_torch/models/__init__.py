"""The port's models: config, layers, the transformer stack (dense, MoE,
whisper's decoder, the vlm backbone), the MoE FFN, the recurrent families,
whisper, the vlm, and the registry of all six families."""
