"""The benchmark's harness: what a run loads by name (`spec`), its seeded
inputs and weights (`traffic`), the measured loop (`harness`), the
comparison that decides `correct` (`judge`), the operations and bytes of
the model and its kernels (`counts`) and the traced run's timeline
(`trace`)."""
