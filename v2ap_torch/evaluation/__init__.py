"""The int8-tower gate's verdict, read by the serving pipeline."""
