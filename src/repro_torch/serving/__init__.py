"""The port's serving plane: ``Cluster`` over simulated or engine
workers, the inference engine and its KV manager, weight provisioning,
recovery, the online session, workloads and the run metrics."""
