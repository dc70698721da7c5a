"""Small utilities: device resolution and on-device sampling."""
