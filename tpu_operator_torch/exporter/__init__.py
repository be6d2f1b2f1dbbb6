"""The metrics exporter (the dcgm-exporter slot): the cards' telemetry as
Prometheus series."""
