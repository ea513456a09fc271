"""One module per kind of mix; a mix file names its kind under ``kind``.
Each module gives ``setup``, ``window``, ``traced``, ``release``, ``work``
and ``check`` (see ``port_bench/run.py``)."""
