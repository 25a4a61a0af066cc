"""Host runtime: the native single-producer / single-consumer sample ring,
built from the port's own C++ source at first use."""

from melspec_tpu_torch.runtime.ringbuffer import (SampleRing,
                                                  native_available, pop_many)

__all__ = ["SampleRing", "native_available", "pop_many"]
