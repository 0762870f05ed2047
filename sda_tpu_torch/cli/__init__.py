"""The ``sda`` agent CLI and the ``sdad`` server daemon (counterpart of ``sda_tpu/cli``)."""
