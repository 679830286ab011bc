// Host-side native I/O for mpc_rs_jax: COBS framing codec + serial port.
//
// Native re-implementation of the reference wire layer
// (src/packet.rs:43-61 cobs stuff/unstuff; examples/mpc-ukf-commu.rs:38-42
// serialport open @115200 with 10 ms timeout; :268-277 read_until(0x00)).
// Runs on the host CPU feeding device arrays; compiled as a shared library
// loaded via ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O2 -shared -fPIC mpcio.cpp -o libmpcio.so)

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <termios.h>
#include <unistd.h>
#include <sys/select.h>
#include <sys/time.h>

extern "C" {

// COBS encode: adds one overhead byte per ≤254-byte run plus a trailing
// 0x00 delimiter (matches cobs_rs::stuff(buf, 0) — src/packet.rs:50).
// Returns encoded length (in_len + 2 for in_len <= 253), or -1.
int mpcio_cobs_stuff(const uint8_t* in, int in_len, uint8_t* out, int out_cap) {
  if (in_len < 0) return -1;
  int out_idx = 1;   // reserve first code byte
  int code_idx = 0;  // position of the current code byte
  uint8_t code = 1;
  for (int i = 0; i < in_len; ++i) {
    if (out_idx + 2 > out_cap) return -1;
    if (in[i] == 0) {
      out[code_idx] = code;
      code_idx = out_idx++;
      code = 1;
    } else {
      out[out_idx++] = in[i];
      if (++code == 0xFF) {
        out[code_idx] = code;
        code_idx = out_idx++;
        code = 1;
      }
    }
  }
  if (out_idx + 1 > out_cap) return -1;
  out[code_idx] = code;
  out[out_idx++] = 0x00;  // frame delimiter
  return out_idx;
}

// COBS decode of a frame that may end with the 0x00 delimiter.
// Returns decoded length, or -1 on malformed input.
int mpcio_cobs_unstuff(const uint8_t* in, int in_len, uint8_t* out, int out_cap) {
  if (in_len > 0 && in[in_len - 1] == 0x00) --in_len;  // strip delimiter
  int out_idx = 0;
  int i = 0;
  while (i < in_len) {
    uint8_t code = in[i++];
    if (code == 0) return -1;
    for (uint8_t j = 1; j < code; ++j) {
      if (i >= in_len) return -1;
      if (out_idx >= out_cap) return -1;
      out[out_idx++] = in[i++];
    }
    if (code != 0xFF && i < in_len) {
      if (out_idx >= out_cap) return -1;
      out[out_idx++] = 0x00;
    }
  }
  return out_idx;
}

static speed_t to_speed(int baud) {
  switch (baud) {
    case 9600: return B9600;
    case 19200: return B19200;
    case 38400: return B38400;
    case 57600: return B57600;
    case 115200: return B115200;
    case 230400: return B230400;
    default: return B115200;
  }
}

// Open a serial device in raw 8N1 mode (mpc-ukf-commu.rs:38-42).
// Returns fd, or -1.
int mpcio_serial_open(const char* dev, int baud) {
  int fd = open(dev, O_RDWR | O_NOCTTY | O_NONBLOCK);
  if (fd < 0) return -1;
  struct termios tio;
  if (tcgetattr(fd, &tio) == 0) {
    cfmakeraw(&tio);
    cfsetispeed(&tio, to_speed(baud));
    cfsetospeed(&tio, to_speed(baud));
    tio.c_cflag |= CLOCAL | CREAD;
    tio.c_cc[VMIN] = 0;
    tio.c_cc[VTIME] = 0;
    tcsetattr(fd, TCSANOW, &tio);  // best-effort: PTYs reject some flags
  }
  return fd;
}

// Read until a 0x00 delimiter or timeout (examples/mpc-ukf-commu.rs:268-277
// BufReader::read_until(0x00) with the port's 10 ms timeout).
// Returns bytes placed in buf (delimiter included), 0 on timeout, -1 error.
int mpcio_serial_read_until_zero(int fd, uint8_t* buf, int cap, int timeout_ms) {
  int n = 0;
  struct timeval deadline, now;
  gettimeofday(&deadline, nullptr);
  deadline.tv_usec += timeout_ms * 1000;
  deadline.tv_sec += deadline.tv_usec / 1000000;
  deadline.tv_usec %= 1000000;
  while (n < cap) {
    uint8_t b;
    ssize_t r = read(fd, &b, 1);
    if (r == 1) {
      buf[n++] = b;
      if (b == 0x00) return n;
      continue;
    }
    if (r < 0 && errno != EAGAIN && errno != EWOULDBLOCK) return -1;
    gettimeofday(&now, nullptr);
    long remain_us = (deadline.tv_sec - now.tv_sec) * 1000000L +
                     (deadline.tv_usec - now.tv_usec);
    if (remain_us <= 0) return n;  // timeout: partial data
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(fd, &rfds);
    struct timeval tv;
    tv.tv_sec = remain_us / 1000000;
    tv.tv_usec = remain_us % 1000000;
    if (select(fd + 1, &rfds, nullptr, nullptr, &tv) <= 0) return n;
  }
  return n;
}

int mpcio_serial_write(int fd, const uint8_t* buf, int len) {
  int done = 0;
  while (done < len) {
    ssize_t r = write(fd, buf + done, len - done);
    if (r < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) continue;
      return -1;
    }
    done += (int)r;
  }
  return done;
}

void mpcio_serial_close(int fd) { close(fd); }

}  // extern "C"
