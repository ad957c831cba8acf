"""Dense decoder model: layers, blocks, prefill/decode and the weight bridge."""
