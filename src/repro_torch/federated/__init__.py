"""Federated learning runtime of the port (:mod:`repro.federated`):
participation masks, local training, the FedAvg server, the synthetic MLP
task, the reference simulators and the batched campaign engine."""
