"""Generate a printable chessboard SVG (cf. reference examples/001)."""

import simplestereo_jax as ss

ss.calibration.generateChessboardSVG((7, 6), "chessboard.svg", squareSize=60)
print("Written chessboard.svg")
