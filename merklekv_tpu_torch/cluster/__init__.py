"""Serving plane of the torch port: the device tree mirror (``mirror``), the
change-event record it reads (``change_event``) and the retry policies
(``retry``)."""
