"""Models of the port (:mod:`repro.models`): the dense transformer family,
its layers, the registry and the kernel-backend knob."""
