"""One reader a metric, found by the metric's name (``<name>.py``, or
``<stem>.py`` with the phase ``train``/``score`` as the name's last part)."""
