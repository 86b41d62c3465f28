"""The numpy host tier of urban_tpu that the port needs, as the port's own
copy: scenario loading, the plan tables and their GeoJSON form
(``envs.plan_client``, ``envs.plan_table``, ``io``), the exact host geometry (``geometry``), the
land-use constants (``city_config``), the run configuration
(``utils``), and the reference API's host path: the exact environment
(``envs.city``, ``envs.observation``, ``envs.render``), the host sampler
and its trajectory memory (``rl``), the episode statistics
(``utils.stats``, ``utils.video``) and the numpy baselines
(``models.baseline``). The port builds its initial state, its trainer's
configuration and its host agent from these, and imports nothing of
``urban_tpu``.

Each module is the file of the same path under ``urban_tpu/`` with its
imports pointed here; ``utils/io.py`` and ``geometry/native.py`` also
count one directory more up to the repo root, where the scenario data
(``urban_tpu/cfg``) and the native contiguity source (``native/``) stay.
``models/baseline.py`` leaves out its last function, ``ga_logits_jax``
(it imports jax; the port's is ``urban_tpu_torch.models.baseline``). ``tests/test_torch_host.py`` holds every copy to its
original.
"""
