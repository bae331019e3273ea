"""The model stack: dense, GQA MoE, VLM, RWKV6 and Zamba2 families (MLA,
the audio family and training are still to port: ROADMAP queue 1, items 9
and 10)."""
