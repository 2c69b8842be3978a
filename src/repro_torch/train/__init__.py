"""repro_torch.train — AdamW, the train step and the fault-tolerant
trainer (a port of ``repro.train``)."""
