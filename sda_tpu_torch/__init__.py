"""PyTorch + CUDA port of the ``sda_tpu`` device plane.

The single-device secure-sum engine (share -> clerk-combine -> reconstruct)
with its fused limb share-and-reduce kernel, and the ChaCha seed-masking
expansion with its ChaCha20 keystream kernel, written for an NVIDIA H100
(``sm_90a``); the sum-first engine and the sharded fabrics; the model
plane that turns float model pytrees into field vectors and back
(``models/``) and the engine's telemetry (``telemetry/``); and the sealed
aggregation round of the protocol plane (``protocol/``, ``crypto/``,
``server/``, ``client/``) on the port's own libsodium-compatible sealed
boxes and signatures, with the recipient's ChaCha reveal on the device.
Layout mirrors ``sda_tpu`` (``ops/``, ``parallel/``, ``protocol/``,
``crypto/``, ``server/``, ``client/``, ``models/``, ``telemetry/``,
``utils/``) so each module's counterpart is easy to find.

The package imports ``torch`` and numpy only: never ``jax`` and nothing of
``sda_tpu`` (it keeps its own copies of the framework-free helpers it
needs). Entry points run on CUDA unless the caller passes ``device="cpu"``,
and raise when no GPU is present (``device.resolve_device``).
"""
