"""The kinds of traffic, one module each (``kinds/<kind>.py``, its class
``Cell``), found by the ``kind`` a traffic mix names."""
