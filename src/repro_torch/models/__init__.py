"""Models: GNMT (slice 1) and the decoder-only LM of the model zoo (slice 2,
dense GQA blocks; slice 3, RWKV-6 blocks); DS2 follows in a later slice."""
