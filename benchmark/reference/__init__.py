"""The plain float32 reference of the FCMAE pretraining step (no import of
the program), its draws, its AdamW and its FLOP count."""
