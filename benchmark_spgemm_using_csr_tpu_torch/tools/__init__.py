"""Measurement tools of the port, run on the card (not imported by the
package)."""
