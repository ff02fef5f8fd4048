"""Training of the port: the data pipeline (``data``), AdamW
(``optimizer``) and the train step (``train_loop``); the fault-tolerant
runner is :mod:`repro_torch.distributed.fault_tolerance`."""
