"""Dense decoder LM: configuration, layers, paged prefill/decode."""
