"""Project Gray-code patterns and capture them with the camera
(cf. reference examples/102). Pattern display needs a GUI environment;
this script only generates the pattern images."""

import simplestereo_jax as ss

n = ss.active.generateGrayCodeImgs("graycode_patterns", (1280, 720))
print(f"Generated {n} patterns in graycode_patterns/")
