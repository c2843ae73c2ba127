"""The benchmark's plain reference, written from the published settings
(``spec``), the raw DLP bank (``scenes``) and the actor ``.npz``
(``actor``): the env step, the observation, found RS paths and the hybrid
takeover (``env_step``), with the three kernels' plain versions frozen
beside them (``kernels``), and the comparisons that decide ``correct``
(``compare``). Imports nothing of the port, of JAX or of the JAX package."""
