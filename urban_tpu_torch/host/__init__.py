"""The numpy host tier of urban_tpu that the port needs, as the port's own
copy: scenario loading and the plan tables (``envs.plan_client``,
``envs.plan_table``, ``io``), the exact host geometry (``geometry``), the
land-use constants (``city_config``) and the run configuration
(``utils``). The port builds its initial state and its trainer's
configuration from these, and imports nothing of ``urban_tpu``.

Each module is the file of the same path under ``urban_tpu/`` with its
imports pointed here; ``utils/io.py`` and ``geometry/native.py`` also
count one directory more up to the repo root, where the scenario data
(``urban_tpu/cfg``) and the native contiguity source (``native/``) stay.
``tests/test_torch_host.py`` holds every copy to its original.
"""
