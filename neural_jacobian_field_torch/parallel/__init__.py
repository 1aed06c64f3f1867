"""Host-to-device staging for one card (the single-card part of the JAX
package's parallel/). Data parallelism across cards is not ported yet."""

from .prefetch import DevicePrefetcher, to_device
