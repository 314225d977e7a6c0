"""GPU probes: the TPU gather probes P1 and P3 (``tools/bench_pallas_gather.py``,
``tools/probes/probe_{sublane_gather,gather_formulations,sampler_blocks}.py``)
as hand-written Hopper kernels (``gather.py``), one case per ``pallas_call``
site (``cases.py``). ``python -m ethzasl_brisk_tpu_torch.probes`` runs every
case on the card.
"""
