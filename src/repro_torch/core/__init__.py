"""FIER core: quantization, retrieval oracles and the decode-backend registry."""
