"""The benchmark of ``mcmcglm_tpu_torch`` on NVIDIA H100 cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once; ``README.md`` says what each file
holds.  Nothing here imports JAX or the JAX package.
"""
