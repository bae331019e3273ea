"""The model stack: the dense, GQA MoE, MLA MoE, VLM, audio, RWKV6 and
Zamba2 families, served and trained."""
