"""The reference-scale validation protocols, each named after the JAX
script it replaces (``scripts/``): ``fabricate`` (``fabricate_dataset.py``,
``fabricate_fast.py``), ``score`` (``eval_headline_common.py``),
``headline`` (``validate_headline.py``), ``long_run`` (``run_long_r04.py``)
and ``tex8k`` (``run_tex8k_r05.py``). ``python -m topo4d_tpu_torch.validate``
runs them."""
