"""Scheduling primitives the port's engine needs: requests, the fitted
latency model and the Eq. 5 token budget."""
