"""Test support shipped with the torch port: the device-plane fault injector
(``device_faults``)."""
