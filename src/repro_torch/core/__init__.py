"""The port's control-plane algorithms, copied from ``repro/core``:
requests, the latency models (with an H100 entry), the Eq. 5 token
budget, the Dispatcher and its policies (Algorithm 1), the priority SLO
mapper (Algorithm 2), the Scaler (Algorithm 3), the Migrator, the
TLManager, instance load and fault injection."""
