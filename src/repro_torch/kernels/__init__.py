"""Hand-written Hopper kernels of the ported paths, each beside its plain
PyTorch version (``topk_mips``, ``embedding_bag``, ``scatter_add``,
``fused_adagrad``, ``feature_extract``, ``embedding_lookup``,
``flash_attention``, ``moe_gmm``), the oracles they are held to (``ref``),
the dispatcher (``ops``) and the build (``build``)."""
