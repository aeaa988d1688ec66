"""Host-side native helpers: ctypes bindings over the repo's C++ audio
library (``native/valle_audio.cc``)."""
