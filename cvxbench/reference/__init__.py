"""The plain reference the program is held to: container, grammar, codec."""
