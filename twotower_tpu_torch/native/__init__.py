"""C++ sources of the port's host-side native code (``flat_index.cpp``, built
at first use by ``serving/cpu_index.py``)."""
