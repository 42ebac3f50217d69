"""PyTorch + CUDA port of the hierarchical parameter server (``repro``).

A package of its own beside the JAX reference: it imports neither JAX nor
anything of ``repro``. The host hierarchy (keys, hash index, MEM-PS,
SSD-PS, nodes, snapshots) is the reference's numpy code, copied; the device
side is PyTorch, and every Pallas kernel on a ported path is a CUDA kernel
written for Hopper (``csrc/``), built at first use.

Ported so far: the ad-serving path — snapshot -> ``ServingEngine`` ->
top-k MIPS search -> embedding-bag rerank (``serve/``, ``retrieval/``); and
CTR training — ``CTRTrainer`` -> ``PSClient``/``hier_ps`` -> the train step
with the bag's backward through ``scatter_add`` and row-Adagrad through
``fused_adagrad`` (``train/``, ``models/``); streaming ingestion — raw
records -> ``StagingRing`` -> ``DeviceIngestor`` hashing keys and slots
through ``feature_extract`` -> the trainer's ingest stage (``ingest/``); and
the rest of the CTR side (grouped slot-group step, LR baseline, OP+OSRP,
elastic reshard); and LM serving for the dense family — ``lookup_device``
-> ``embed_gather`` through ``embedding_lookup`` -> prefill through
``flash_attention`` -> greedy decode (``serve/serve_step.py``, ``models/``).
"""
