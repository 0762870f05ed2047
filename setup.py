"""Build the native extension: ``python setup.py build_ext --inplace``.

Links directly against the system libsodium runtime (the image ships
``libsodium.so.23`` without dev headers; the extension declares the stable
ABI itself). Pure-Python fallbacks exist for every native function, so the
package works without building — the extension is the bulk-throughput path.
"""

from setuptools import Extension, setup

setup(
    name="sda-tpu",
    version="0.1.0",
    packages=[
        "sda_tpu",
        "sda_tpu.protocol",
        "sda_tpu.ops",
        "sda_tpu.crypto",
        "sda_tpu.client",
        "sda_tpu.server",
        "sda_tpu.rest",
        "sda_tpu.parallel",
        "sda_tpu.cli",
        "sda_tpu.native",
        "sda_tpu.utils",
        "sda_tpu_torch",
        "sda_tpu_torch.ops",
        "sda_tpu_torch.parallel",
        "sda_tpu_torch.protocol",
        "sda_tpu_torch.crypto",
        "sda_tpu_torch.server",
        "sda_tpu_torch.client",
        "sda_tpu_torch.models",
        "sda_tpu_torch.telemetry",
        "sda_tpu_torch.utils",
        "sda_tpu_torch.examples",
        "sda_tpu_torch.sketches",
        "sda_tpu_torch.rest",
        "sda_tpu_torch.cli",
        "sda_tpu_torch.native",
    ],
    ext_modules=[
        Extension(
            "sda_tpu.native._sdanative",
            sources=["sda_tpu/native/_sdanative.c"],
            extra_link_args=["-l:libsodium.so.23"],
            extra_compile_args=["-O3"],
            depends=["sda_tpu/native/curve25519_comb.c"],
        )
    ],
)
